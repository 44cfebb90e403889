"""Mixer: 4 loop channels + clip grid, with stem rendering.

Behavioral reference: src/mixer/mod.rs (655 LoC) — owns the loop channels
and the ClipGrid; `tick()` runs grid.before_tick (transport + scheduled
actions), solo-aware channel gating, the channel sum, grid.after_tick;
propagates BPM to channel effects + grid (rs:80-87); offline single-channel
render with effect-warming preroll (`render_channel_to_interleaved`,
rs:444-476).
"""

from __future__ import annotations

from functools import partial
from typing import List

import jax
import jax.numpy as jnp
import numpy as np

from libgooey_tpu.core.smoother import SmootherBank, smoothing_coeff, smooth_block
from libgooey_tpu.mixer import chain as chain_mod
from libgooey_tpu.mixer.clip_grid import CLIP_COLUMNS, ClipGrid
from libgooey_tpu.mixer.loop_channel import LoopChannelHost
from libgooey_tpu.mixer.stereo_buffer import read_cubic

NUM_CHANNELS = 4  # mixer/mod.rs:31


@partial(jax.jit, static_argnames=("wrap", "chain_key", "sample_rate", "coeff"))
def _channel_block(buffer, pos, weights, base, length, gain_bank, chain_states,
                   chain_targets, *, wrap: bool, chain_key, sample_rate: float,
                   coeff: float):
    """One loop channel: OLA cubic reads → gain → chain → active gate.

    ``buffer`` holds two capacity regions (active + staged) so a quantized
    swap can land mid-block; ``base``/``length`` locate each sample's region.
    """
    B = pos.shape[-1]
    dry = (
        read_cubic(buffer, pos[0], wrap, length, base) * weights[0][None, :]
        + read_cubic(buffer, pos[1], wrap, length, base) * weights[1][None, :]
    )
    bank, traj = smooth_block(gain_bank, coeff, B)      # [2, B]: gain, active
    gained = dry * traj[0][None, :]
    new_states, wet = chain_mod.process_chain(
        chain_states, gained, chain_targets, chain_key, sample_rate=sample_rate
    )
    return bank, new_states, wet * traj[1][None, :]


@partial(jax.jit, static_argnames=("wrap", "chain_key", "sample_rate", "coeff"))
def _channel_blocks(buffer, pos, weights, base, length, targets_seq, gain_bank,
                    chain_states, chain_targets, *, wrap: bool, chain_key,
                    sample_rate: float, coeff: float):
    """K-block scanned twin of :func:`_channel_block`.

    ``pos``/``weights`` are ``[K, 2, B]`` host-planned read streams,
    ``targets_seq`` the per-block gain/gate targets ``[K, 2]``.  One
    device dispatch renders all K blocks (the per-block math is identical
    to `_channel_block`; only the dispatch granularity changes), so the
    per-call dispatch floor amortizes K× for offline renders.
    Returns ``(gain_bank', chain_states', wet[K, 2, B])``.
    """

    def body(carry, xs):
        bank, states = carry
        p, w, ba, ln, tg = xs
        bank = bank.with_targets(tg)
        dry = (
            read_cubic(buffer, p[0], wrap, ln, ba) * w[0][None, :]
            + read_cubic(buffer, p[1], wrap, ln, ba) * w[1][None, :]
        )
        bank, traj = smooth_block(bank, coeff, p.shape[-1])
        gained = dry * traj[0][None, :]
        states, wet = chain_mod.process_chain(
            states, gained, chain_targets, chain_key, sample_rate=sample_rate
        )
        return (bank, tuple(states)), wet * traj[1][None, :]

    (bank, states), wets = jax.lax.scan(
        body, (gain_bank, tuple(chain_states)),
        (pos, weights, base, length, targets_seq),
    )
    return bank, states, wets


class Mixer:
    def __init__(self, sample_rate: float, bpm: float = 120.0,
                 block_size: int = 512, buffer_capacity: int = 1 << 21):
        self.sr = sample_rate
        self.block = block_size
        self.bpm = bpm
        self.channels: List[LoopChannelHost] = [
            LoopChannelHost(sample_rate, buffer_capacity) for _ in range(NUM_CHANNELS)
        ]
        self.clip_grid = ClipGrid(sample_rate, bpm)
        self.capacity = buffer_capacity
        self._dev_buffers = [
            jnp.zeros((2, 2 * buffer_capacity), jnp.float32)
            for _ in range(NUM_CHANNELS)
        ]
        self._gain_banks = [
            SmootherBank.init(np.array([1.0, 1.0], np.float32))
            for _ in range(NUM_CHANNELS)
        ]
        self._coeff = smoothing_coeff(sample_rate)

    def set_bpm(self, bpm: float):
        """Propagate BPM to channels' delay timings + grid (mod.rs:80-87)."""
        self.bpm = bpm
        self.clip_grid.set_bpm(bpm)
        for ch in self.channels:
            ch.engine_bpm = bpm
            ch.chain.set_bpm(bpm)

    def _silent(self, i: int) -> bool:
        """True when channel ``i`` contributes exact silence this block AND
        skipping its host sweep + device dispatch is state-neutral: no
        loaded or staged buffer (nothing to read or land) and an empty
        effect chain (no tails to ring out; the gain/gate smoothers of a
        silent channel scale zeros, so holding them is exact)."""
        ch = self.channels[i]
        return (ch.buffer is None and ch.pending is None
                and ch.region_buffers[0] is None
                and ch.region_buffers[1] is None
                and not ch.chain.entries)

    def _upload_if_dirty(self, i: int):
        ch = self.channels[i]
        for r in range(2):
            if ch.region_dirty[r] and ch.region_buffers[r] is not None:
                arr = ch.region_buffers[r].device_array()
                self._dev_buffers[i] = (
                    self._dev_buffers[i]
                    .at[:, r * self.capacity : r * self.capacity + arr.shape[-1]]
                    .set(jnp.asarray(arr))
                )
                ch.region_dirty[r] = False

    def render_block(self):
        """One block → stereo sum ``[2, B]`` (device array)."""
        B = self.block
        actions = self.clip_grid.before_tick(self.channels, B)
        any_solo = any(ch.soloed for ch in self.channels)
        total = jnp.zeros((2, B), jnp.float32)
        for i, ch in enumerate(self.channels):
            ch.audible = (not ch.muted) and ((not any_solo) or ch.soloed)
            if self._silent(i) and i not in actions:
                continue
            self._upload_if_dirty(i)  # staged swaps upload before the sweep lands
            pos, weights, region, length, wraps = ch.sweep_positions(
                B, actions.get(i, ())
            )
            self._upload_if_dirty(i)
            self._gain_banks[i] = self._gain_banks[i].with_targets(
                np.array([ch.gain_target, 1.0 if ch.audible else 0.0], np.float32)
            )
            bank, new_states, wet = _channel_block(
                self._dev_buffers[i], jnp.asarray(pos), jnp.asarray(weights),
                jnp.asarray(region * self.capacity), jnp.asarray(length),
                self._gain_banks[i], tuple(ch.chain.states),
                tuple(ch.chain.targets_list()),
                wrap=bool(wraps), chain_key=ch.chain.static_key(),
                sample_rate=self.sr, coeff=self._coeff,
            )
            self._gain_banks[i] = bank
            ch.chain.states = list(new_states)
            total = total + wet
        self.clip_grid.after_tick(B)
        return total

    def render_blocks(self, n_blocks: int, collect_beats=None):
        """Batched offline render: plan ``n_blocks`` blocks on the host,
        then dispatch ONE scanned device program per channel.

        Semantically equivalent to ``n_blocks`` :meth:`render_block` calls —
        the same f64 sweeps, quantized swaps, clip-grid actions and gain
        trajectories run host-side in the same order; only the device
        dispatch granularity changes, so the per-block dispatch
        floor amortizes ``n_blocks``×.  Returns ``[2, n_blocks * block]``
        (device array).

        A channel whose window wrap-ness changes mid-batch is split into
        maximal uniform-wrap runs (wrap-ness is a trace-static read mode).

        ``collect_beats``: optional list — appends one
        ``(transport_beat, transport_running)`` tuple per block, read
        BEFORE that block's ``before_tick`` (the value
        ``GooeyEngine._render_one_block`` sees for the same block); used
        by the product span planner.
        """
        from libgooey_tpu.mixer import stream as stream_mod

        B = self.block
        K = int(n_blocks)
        #: silent channels skip host sweeps AND device dispatch for the
        #: whole span; safe to decide up front — no host API runs mid-span,
        #: so the only way a skipped channel could wake is a scheduled grid
        #: action, checked here
        skip = [self._silent(i)
                and self.clip_grid.pending[i] is None
                and self.clip_grid.pending_retrim[i] is None
                for i in range(len(self.channels))]
        stream_cfgs = [stream_mod.stream_config(self, i, K)
                       for i in range(len(self.channels))]
        plans = [[] for _ in self.channels]   # per channel: (pos, w, base, len, wrap)
        targets = [[] for _ in self.channels]
        for _k in range(K):
            if collect_beats is not None:
                collect_beats.append((self.clip_grid.transport_beat,
                                      self.clip_grid.transport_running))
            actions = self.clip_grid.before_tick(self.channels, B)
            any_solo = any(ch.soloed for ch in self.channels)
            for i, ch in enumerate(self.channels):
                ch.audible = (not ch.muted) and ((not any_solo) or ch.soloed)
                if skip[i]:
                    continue
                targets[i].append(
                    np.array([ch.gain_target, 1.0 if ch.audible else 0.0],
                             np.float32)
                )
                if stream_cfgs[i] is not None:
                    continue  # rendered through the device hop scan below
                self._upload_if_dirty(i)
                pos, weights, region, length, wraps = ch.sweep_positions(
                    B, actions.get(i, ())
                )
                self._upload_if_dirty(i)
                plans[i].append((pos, weights, region, length, bool(wraps)))
            self.clip_grid.after_tick(B)

        total = jnp.zeros((2, K * B), jnp.float32)
        finalizers = []
        # ALL streamed channels' hop scans run as ONE vmapped dispatch
        # (stream.render_stream_channels); channels it can't take (batch
        # shorter than the hop remainder) fall back to host planning below
        stream_items = [(i, stream_cfgs[i])
                        for i in range(len(self.channels))
                        if not skip[i] and stream_cfgs[i] is not None]
        streamed = stream_mod.render_stream_channels(
            self, stream_items, K,
            {i: np.stack(targets[i]) for i, _ in stream_items},
        ) if stream_items else {}
        for i, ch in enumerate(self.channels):
            if skip[i]:
                continue
            if stream_cfgs[i] is not None:
                if i in streamed:
                    wets, wb, fin = streamed[i]
                    total = total + wets.transpose(1, 0, 2).reshape(2, -1)
                    finalizers.append((wb, fin))
                    continue
                # batch shorter than the hop remainder: host-plan it instead
                for _k in range(K):
                    pos, weights, region, length, wraps = ch.sweep_positions(B)
                    plans[i].append((pos, weights, region, length, bool(wraps)))
            wet_runs = []
            k0 = 0
            while k0 < K:
                wrap = plans[i][k0][4]
                k1 = k0
                while k1 < K and plans[i][k1][4] == wrap:
                    k1 += 1
                run = plans[i][k0:k1]
                pos = jnp.asarray(np.stack([p for p, *_ in run]))
                wts = jnp.asarray(np.stack([w for _, w, *_ in run]))
                base = jnp.asarray(
                    np.stack([r for _, _, r, *_ in run]) * self.capacity
                )
                length = jnp.asarray(np.stack([ln for *_x, ln, _w in run]))
                tgt = jnp.asarray(np.stack(targets[i][k0:k1]))
                bank, new_states, wets = _channel_blocks(
                    self._dev_buffers[i], pos, wts, base, length, tgt,
                    self._gain_banks[i], tuple(ch.chain.states),
                    tuple(ch.chain.targets_list()),
                    wrap=wrap, chain_key=ch.chain.static_key(),
                    sample_rate=self.sr, coeff=self._coeff,
                )
                self._gain_banks[i] = bank
                ch.chain.states = list(new_states)
                wet_runs.append(wets.transpose(1, 0, 2).reshape(2, -1))
                k0 = k1
            total = total + jnp.concatenate(wet_runs, axis=-1)
        # materialize the streamed channels' scheduler write-backs AFTER
        # every channel has dispatched: each GROUP's write-back is one
        # stacked array whose D2H was started right after the hop dispatch
        # (stream.render_stream_channels), so it downloads while the tail
        # programs run — one overlap-hidden transfer per group instead of
        # a blocking round trip per channel
        if finalizers:
            host_wbs = {}
            for (wb, row), fin in finalizers:
                key = id(wb)
                if key not in host_wbs:
                    host_wbs[key] = np.asarray(wb)
                fin(host_wbs[key][row])
        return total

    # --- offline stem render (mod.rs:444-476) -----------------------------------

    def render_channel_to_buffer(self, index: int, frames: int,
                                 preroll_blocks: int = 8) -> np.ndarray:
        """Render one channel solo to ``[2, frames]``: reset its effects, warm
        them with a discarded preroll, restart the cursor, capture exactly
        ``frames`` (gain baked from sample 0; mute/solo ignored)."""
        ch = self.channels[index]
        if ch.buffer is None:
            return np.zeros((2, frames), np.float32)
        ch.chain.reset()
        saved_cursor = ch.cursor
        saved_playing = ch.playing
        ch.playing = True
        bank = SmootherBank.init(np.array([ch.gain_target, 1.0], np.float32))
        self._upload_if_dirty(index)

        def run(n_samples, collect):
            nonlocal bank
            out = []
            done = 0
            while done < n_samples:
                pos, weights, region, length, wraps = ch.sweep_positions(self.block)
                bank2, new_states, wet = _channel_block(
                    self._dev_buffers[index], jnp.asarray(pos), jnp.asarray(weights),
                    jnp.asarray(region * self.capacity), jnp.asarray(length),
                    bank, tuple(ch.chain.states), tuple(ch.chain.targets_list()),
                    wrap=bool(wraps), chain_key=ch.chain.static_key(),
                    sample_rate=self.sr, coeff=self._coeff,
                )
                bank = bank2
                ch.chain.states = list(new_states)
                if collect:
                    out.append(np.asarray(wet))
                done += self.block
            return np.concatenate(out, axis=-1)[:, :n_samples] if collect else None

        # preroll warms the effect tails, then restart and capture
        run(preroll_blocks * self.block, collect=False)
        ch.restart()
        result = run(frames, collect=True)
        ch.cursor = saved_cursor
        ch.playing = saved_playing
        return result

    def render_channel_to_wav(self, index: int, frames: int, path, bits: int = 32):
        from libgooey_tpu.io_wav import write_wav

        buf = self.render_channel_to_buffer(index, frames)
        write_wav(path, buf, int(self.sr), bits=bits)
        return buf
