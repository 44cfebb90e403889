"""Batched device-resident WSOLA rendering for PreservePitch loop channels.

Host glue around :mod:`libgooey_tpu.ops.wsola_stream`: maps the
``WsolaHost`` scheduler state onto the device scan, renders ``K`` blocks
in ONE dispatch (partial-hop prefix + ``n_hops`` full hops + gain/chain
scan), and writes the final hop state back so the host scheduler can
continue seamlessly — per-block rendering, another batch, or a queued
swap all pick up exactly where the device left off.

Engages from :meth:`Mixer.render_blocks` when a channel is PreservePitch
with the device search enabled, no pending swap, and no clip-grid action
scheduled for its column within the span (a RUNNING transport with no due
action streams — grid actions are beat-scheduled, so the span horizon is
known at planning time; see :func:`stream_config`).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from libgooey_tpu.core.smoother import smooth_block
from libgooey_tpu.mixer import chain as chain_mod
from libgooey_tpu.mixer import wsola
from libgooey_tpu.mixer.loop_channel import PITCH_PRESERVE
from libgooey_tpu.mixer.stereo_buffer import read_cubic
from libgooey_tpu.ops import wsola_stream as dws


@partial(jax.jit, static_argnames=("cfg", "n_hops", "K", "B", "wrap_read",
                                   "chain_key", "sample_rate", "coeff"))
def _stream_channel(buf2, prefix_pos, prefix_w, r0, cur_i, cur_f, have_prev,
                    ref_tail, ptail_pos, ptail_valid, w1, w2, targets_seq,
                    gain_bank, chain_states, chain_targets, *, cfg, n_hops: int,
                    K: int, B: int, wrap_read: bool, chain_key,
                    sample_rate: float, coeff: float):
    """One dispatch: prefix + hop scan + slice + per-block gain/chain."""
    rows = jnp.concatenate([(buf2[0] + buf2[1])[None, :], buf2], axis=0)
    P3 = dws.pad_buffer(rows, cfg)
    pre = (
        read_cubic(buf2, prefix_pos[0], wrap_read) * prefix_w[0][None, :]
        + read_cubic(buf2, prefix_pos[1], wrap_read) * prefix_w[1][None, :]
    )
    ptail = read_cubic(buf2, ptail_pos, wrap_read) * w2[None, :] * ptail_valid
    state = dws.state_tuple((cur_i, cur_f, have_prev, ref_tail, ptail))
    carry, bi, bf, hps, ys = dws.stream_hops(
        P3, w1, w2, state, n_hops=n_hops, cfg=cfg)
    full = jnp.concatenate([pre, ys.transpose(1, 0, 2).reshape(2, -1)], axis=1)
    out = jax.lax.dynamic_slice(
        full, (0, (cfg.hop - r0).astype(jnp.int32)), (2, K * B))
    dry = out.reshape(2, K, B).transpose(1, 0, 2)

    def body(c, xs):
        bank, states = c
        d, tg = xs
        bank = bank.with_targets(tg)
        bank, traj = smooth_block(bank, coeff, B)
        gained = d * traj[0][None, :]
        states, wet = chain_mod.process_chain(
            states, gained, chain_targets, chain_key, sample_rate=sample_rate
        )
        return (bank, tuple(states)), wet * traj[1][None, :]

    (bank, states), wets = jax.lax.scan(
        body, (gain_bank, tuple(chain_states)), (dry, targets_seq))
    _cur, _hp, ref_out, _pt = carry
    # pack the host write-back into ONE small array so the scheduler
    # update costs a single download, not four
    f32 = jnp.float32
    z = f32(0.0)
    wb = jnp.concatenate([
        ref_out,
        jnp.stack([bi[-1], bf[-1],
                   bi[-2] if n_hops >= 2 else z,
                   bf[-2] if n_hops >= 2 else z,
                   hps[-1].astype(f32)]),
    ])
    return bank, states, wets, wb


def stream_config(mixer, i, n_blocks: int = 0):
    """Static stream config for channel ``i``, or None if ineligible.

    A RUNNING clip-grid transport no longer disqualifies the channel —
    grid actions are beat-scheduled, so the host knows at span-planning
    time whether anything can land on this column within ``n_blocks``
    (clip_grid.rs:582+: activations fire at scheduled beats).  Only a
    pending launch/stop/retrim for THIS column inside the span horizon
    forces the per-block host path; live clip-grid playback — the
    headline feature WSOLA exists for — stays on the batched device scan.
    """
    ch = mixer.channels[i]
    if (
        not ch.playing
        or ch.buffer is None
        or ch.pitch_mode != PITCH_PRESERVE
        or ch.speed < 0.0
        or ch.pending is not None
    ):
        return None
    grid = mixer.clip_grid
    if grid.transport_running:
        bps = grid.beats_per_sample()
        horizon = grid.transport_beat + n_blocks * mixer.block * bps + bps
        p = grid.pending[i]
        r = grid.pending_retrim[i]
        if (p is not None and p.beat < horizon) or (
                r is not None and r.beat < horizon):
            return None
    use_dev = (ch._stretcher.use_device if ch._stretcher is not None
               else wsola.USE_DEVICE_SEARCH)
    if not use_dev:
        return None
    L = len(ch.buffer)
    w = ch.window(float(L))
    return dws.make_config(mixer.sr, ch.buffer.sample_rate, L, w.lo, w.span,
                           w.wraps, ch.speed, ch.warp_ratio())


def _prep_channel(mixer, i, K: int, cfg):
    """Host-side prep shared by the single-channel and batched paths.

    Returns a dict of everything the device dispatch needs, or None when
    the batch is shorter than the current hop remainder (caller falls
    back to the host-planned path for this channel)."""
    ch = mixer.channels[i]
    B = mixer.block
    T = K * B
    host = ch._stretcher
    if host is None:
        host = ch._stretcher = wsola.WsolaHost(mixer.sr, ch.cursor)
    hop = cfg.hop
    r0 = hop - host.drain_idx if host.drain_idx < hop else 0
    if T <= r0:
        return None

    L = float(len(ch.buffer))
    w = ch.window(L)
    ratio = ch.buffer.sample_rate / max(mixer.sr, 1.0)
    warp = ch.warp_ratio()

    ppos = np.zeros((2, hop), np.float64)
    pw = np.zeros((2, hop), np.float32)
    if r0:
        pos, wts, _cur = host.plan_block(r0, ch.buffer, w, ratio, ch.speed,
                                         warp)
        ppos[:, hop - r0:] = pos
        pw[:, hop - r0:] = wts
    n_hops = -(-(T - r0) // hop)

    v = (w.to_virtual(host.analysis_cursor) if w.wraps
         else (host.analysis_cursor - w.lo))
    have_prev = bool(host.have_prev)
    ref_tail = (np.asarray(host.prev_tail_mono, np.float32) if have_prev
                else np.zeros(hop, np.float32))
    if have_prev:
        idx = np.arange(hop)
        pos_v = np.clip(host.cur_start_v + (hop + idx) * host.cur_step,
                        0.0, w.span)
        ptail_pos = (np.mod(w.lo + pos_v, w.len) if w.wraps
                     else (w.lo + pos_v))
        pvalid = 1.0
    else:
        ptail_pos = np.zeros(hop, np.float64)
        pvalid = 0.0

    mixer._upload_if_dirty(i)
    base = ch.active_region * mixer.capacity
    buf2 = mixer._dev_buffers[i][:, base:base + int(L)]
    return dict(ch=ch, host=host, w=w, L=L, hop=hop, r0=r0, n_hops=n_hops,
                ppos=ppos, pw=pw, v=float(v), have_prev=have_prev,
                ref_tail=ref_tail, ptail_pos=ptail_pos, pvalid=pvalid,
                buf2=buf2, T=T)


def _mk_finalize(mixer, i, p, cfg):
    """The host-scheduler write-back closure (shared by both paths)."""
    ch, host, w = p["ch"], p["host"], p["w"]
    hop, n_hops, r0, T = p["hop"], p["n_hops"], p["r0"], p["T"]
    prev_cur_start = getattr(host, "cur_start_v", None)
    prev_cur_step = getattr(host, "cur_step", cfg.step)

    def finalize(wb_host):
        wb_host = np.asarray(wb_host, np.float64)
        ref_out = wb_host[:hop].astype(np.float32)
        last_i, last_f, prev_i, prev_f, last_hp = wb_host[hop:hop + 5]
        best_last = last_i + last_f
        if n_hops >= 2:
            host.prev_start_v = prev_i + prev_f
            host.prev_step = cfg.step
        else:
            host.prev_start_v = (prev_cur_start if prev_cur_start is not None
                                 else best_last)
            host.prev_step = float(prev_cur_step)
        host.cur_start_v = best_last
        host.cur_step = cfg.step
        host.had_prev_for_cur = bool(last_hp > 0.5)
        host.have_prev = True
        host.prev_tail_mono = ref_out
        host.analysis_cursor = float(
            np.mod(w.lo + best_last, w.len) if w.wraps
            else (w.lo + best_last))
        host.drain_idx = int((T - r0) - (n_hops - 1) * hop)
        host._buffer_sr = ch.buffer.sample_rate
        ch.cursor = host.analysis_cursor

    return finalize


@partial(jax.jit, static_argnames=("cfg", "n_hops", "wrap_read"))
def _stream_hops_batched_jit(P3c, ptail_pos, pvalid, w1, w2, cur_i, cur_f,
                             have_prev, ref_tail, n_active, dyn, *, cfg,
                             n_hops: int, wrap_read: bool):
    """Batched hop dispatch: per-channel ptail reads from the padded rows
    + ONE vmapped hop scan + the packed per-channel write-backs."""
    hop = cfg.hop
    C = P3c.shape[0]

    def read_ptail(rows, pos):
        # rows = padded [3, W]; positions are pre-wrapped host coords, so a
        # flat read at pos+4 sees exactly the host taps (pad_buffer layout)
        return read_cubic(rows[1:3], pos + 4.0, False) * w2[None, :]

    ptail = jax.vmap(read_ptail)(P3c, ptail_pos) * pvalid[:, None, None]
    state = ((cur_i, cur_f), have_prev, ref_tail, ptail)
    carry, bi, bf, hps, ys = dws.stream_hops_batched(
        P3c, w1, w2, state, n_active, dyn, n_hops=n_hops, cfg=cfg)
    _cur, _hp, ref_out, _pt = carry

    # packed write-back rows [C, hop + 5]
    f32 = jnp.float32
    last = jnp.maximum(n_active - 1, 0)
    prev = jnp.maximum(n_active - 2, 0)
    ch_idx = jnp.arange(C)
    pick = lambda a, t: a[t, ch_idx]
    has2 = (n_active >= 2).astype(f32)
    wb = jnp.concatenate([
        ref_out,
        jnp.stack([pick(bi, last), pick(bf, last),
                   pick(bi, prev) * has2, pick(bf, prev) * has2,
                   pick(hps, last).astype(f32)], axis=-1),
    ], axis=-1)
    return ys, wb


@partial(jax.jit, static_argnames=("n_hops", "hop", "K", "B", "wrap_read",
                                   "chain_key", "sample_rate", "coeff"))
def _stream_tail(buf2, prefix_pos, prefix_w, r0, ys_c, targets_seq,
                 gain_bank, chain_states, chain_targets, *, n_hops: int,
                 hop: int, K: int, B: int, wrap_read: bool, chain_key,
                 sample_rate: float, coeff: float):
    """Per-channel epilogue: prefix read + slice + gain/chain scan."""
    pre = (
        read_cubic(buf2, prefix_pos[0], wrap_read) * prefix_w[0][None, :]
        + read_cubic(buf2, prefix_pos[1], wrap_read) * prefix_w[1][None, :]
    )
    full = jnp.concatenate([pre, ys_c.transpose(1, 0, 2).reshape(2, -1)],
                           axis=1)
    out = jax.lax.dynamic_slice(
        full, (0, (hop - r0).astype(jnp.int32)), (2, K * B))
    dry = out.reshape(2, K, B).transpose(1, 0, 2)

    if not chain_key:
        # empty chain (the live clip-grid case): the K per-block smoother
        # steps have a closed form, so the whole tail is one vectorized
        # elementwise op instead of a K-step scan of tiny kernels.
        # Mirrors smooth_block exactly: block k starts from block k-1's
        # end value, with the reference's 1e-4 settle snap per sample.
        q = jnp.float32(1.0 - coeff)
        powers = jnp.power(q, jnp.arange(1, B + 1, dtype=jnp.float32))
        eps = jnp.float32(1e-4)

        def block_step(cur, tgt):
            decayed = (cur - tgt)[:, None] * powers[None, :]
            traj = tgt[:, None] + jnp.where(jnp.abs(decayed) < eps, 0.0,
                                            decayed)
            return traj[:, -1], traj

        cur_last, trajs = jax.lax.scan(block_step, gain_bank.current,
                                       targets_seq)            # [K, 2, B]
        wets = dry * trajs[:, 0][:, None, :] * trajs[:, 1][:, None, :]
        bank = type(gain_bank)(current=cur_last, target=targets_seq[-1])
        return bank, tuple(chain_states), wets

    def body(c, xs):
        bank, states = c
        d, tg = xs
        bank = bank.with_targets(tg)
        bank, traj = smooth_block(bank, coeff, B)
        gained = d * traj[0][None, :]
        states, wet = chain_mod.process_chain(
            states, gained, chain_targets, chain_key, sample_rate=sample_rate
        )
        return (bank, tuple(states)), wet * traj[1][None, :]

    (bank, states), wets = jax.lax.scan(
        body, (gain_bank, tuple(chain_states)), (dry, targets_seq))
    return bank, states, wets


def render_stream_channels(mixer, items, K: int, targets_by_ch):
    """Dispatch K blocks for SEVERAL stream channels at once.

    ``items``: list of ``(i, cfg)``.  The hop scans of all channels run
    as ONE vmapped device scan (grouped by window wrap-ness — a static
    read mode); prefix/chain epilogues stay per-channel (their chain
    keys are static per channel).  Returns ``{i: (wets, wb_row_index,
    finalize)}`` plus the stacked write-back array — the caller downloads
    it ONCE and feeds each row to its finalize (one round trip
    for the whole batch instead of one per channel).  Channels whose
    batch is shorter than their hop remainder are absent from the result
    (caller falls back to the host-planned path).
    """
    B = mixer.block
    preps = {}
    for i, cfg in items:
        p = _prep_channel(mixer, i, K, cfg)
        if p is not None:
            preps[i] = (cfg, p)
    out = {}
    # group by wrap-ness (trace-static read mode)
    for wraps in (False, True):
        group = [(i, cfg, p) for i, (cfg, p) in preps.items()
                 if cfg.wraps == wraps]
        if not group:
            continue
        hop = group[0][1].hop
        U = max(cfg.U for _i, cfg, _p in group)
        nf = max(cfg.nf for _i, cfg, _p in group)
        grainB = max(cfg.grainB for _i, cfg, _p in group)
        hopB = max(cfg.hopB for _i, cfg, _p in group)
        shared = group[0][1]._replace(U=U, nf=nf, grainB=grainB, hopB=hopB)
        n_hops = max(p["n_hops"] for _i, _cfg, p in group)
        Wmax = max(int(p["L"]) for _i, _cfg, p in group) + 4 + U

        P3_rows, dyn_rows = [], []
        for i, cfg, p in group:
            # padded-row construction only changes when the buffer/window/
            # padding geometry does — cache it on the channel (rebuilding
            # cost ~10 ms of host dispatch per batch across 4 channels)
            ch = p["ch"]
            key = (ch.active_region, cfg.wraps, U, Wmax)
            cached = getattr(ch, "_p3_cache", None)
            if (cached is not None and cached[0] == key
                    and cached[2] is ch.buffer):
                P3 = cached[1]
            else:
                buf2 = p["buf2"]
                rows = jnp.concatenate([(buf2[0] + buf2[1])[None, :], buf2],
                                       axis=0)
                P3 = dws.pad_buffer(rows, cfg._replace(U=U))
                pad = Wmax - P3.shape[1]
                if pad:
                    P3 = jnp.pad(P3, ((0, 0), (0, pad)))
                ch._p3_cache = (key, P3, ch.buffer)
            P3_rows.append(P3)
            dyn_rows.append(dws._static_dyn(cfg))
        P3c = jnp.stack(P3_rows)
        dyn = {k: jnp.asarray([d[k] for d in dyn_rows], jnp.float32)
               for k in dyn_rows[0]}
        host0 = group[0][2]["host"]
        w1 = jnp.asarray(host0.window[:hop])
        w2 = jnp.asarray(host0.window[hop:])
        ys, wb = _stream_hops_batched_jit(
            P3c,
            jnp.asarray(np.stack([p["ptail_pos"] for _i, _c, p in group])),
            jnp.asarray(np.array([p["pvalid"] for _i, _c, p in group],
                                 np.float32)),
            w1, w2,
            jnp.asarray(np.floor([p["v"] for _i, _c, p in group]
                                 ).astype(np.float32)),
            jnp.asarray(np.array([p["v"] - np.floor(p["v"])
                                  for _i, _c, p in group], np.float32)),
            jnp.asarray(np.array([p["have_prev"] for _i, _c, p in group])),
            jnp.asarray(np.stack([p["ref_tail"] for _i, _c, p in group])),
            jnp.asarray(np.array([p["n_hops"] for _i, _c, p in group],
                                 np.int32)),
            dyn, cfg=shared, n_hops=n_hops, wrap_read=wraps,
        )
        # start the write-back D2H now: it depends only on the hop scan,
        # so the copy runs WHILE the tail programs below run —
        # by the time the caller materializes it, it has usually landed
        try:
            wb.copy_to_host_async()
        except AttributeError:
            pass
        for row, (i, cfg, p) in enumerate(group):
            ch = p["ch"]
            bank, states, wets = _stream_tail(
                p["buf2"], jnp.asarray(p["ppos"]), jnp.asarray(p["pw"]),
                jnp.int32(p["r0"]), ys[:p["n_hops"], row],
                jnp.asarray(targets_by_ch[i]), mixer._gain_banks[i],
                tuple(ch.chain.states), tuple(ch.chain.targets_list()),
                n_hops=p["n_hops"], hop=hop, K=K, B=B, wrap_read=wraps,
                chain_key=ch.chain.static_key(), sample_rate=mixer.sr,
                coeff=mixer._coeff,
            )
            mixer._gain_banks[i] = bank
            ch.chain.states = list(states)
            out[i] = (wets, (wb, row), _mk_finalize(mixer, i, p, cfg))
    return out


def render_stream_channel(mixer, i, K: int, targets_np, cfg):
    """Single-channel wrapper over :func:`render_stream_channels`.

    Returns ``(wets, wb, finalize)`` or None when the batch is shorter
    than the current hop remainder (caller falls back to the host-planned
    path)."""
    res = render_stream_channels(mixer, [(i, cfg)], K, {i: targets_np})
    return res.get(i)
