"""The native Engine: named instruments, sequencers, master bus.

Behavioral reference: src/engine/mod.rs (486 LoC) — a HashMap of named
instruments, a trigger queue, sequencers and LFOs routed by name, global
effects (SoftLimiter default), a smoothed master gain (default 0.25) and a
per-instrument smoothed pan.

Device architecture: instruments of the same family live in one device-resident
*bank* (``[V, ...]`` state pytree); a named instrument is a voice slot.  The
host engine is the control plane: it runs sequencers/trigger queues in exact
arithmetic, stages parameter targets, and drives one jitted block step

    step(state, events) -> (state', stereo[2, B])

whose inner mix is ``einsum(pan_gains[2,V,B], voices[V,B])`` — a matmul when
pans are settled.  The host loop is the analog of the reference's audio
callback; nothing audio-rate ever runs in Python.
"""

from __future__ import annotations

from functools import partial
from typing import Dict, List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from libgooey_tpu.core import dsp
from libgooey_tpu.core.constants import (
    DEFAULT_BLOCK_SIZE,
    DEFAULT_SAMPLE_RATE,
    SMOOTHER_SETTLE_EPS,
)
from libgooey_tpu.core.smoother import (
    SmootherBank,
    smoothing_coeff,
    smooth_block,
    smooth_block_lazy,
)
from libgooey_tpu.effects import (
    compressor as fx_compressor,
    delay as fx_delay,
    limiter,
    lowpass as fx_lowpass,
    reverb_plate as fx_plate,
    reverb_spring as fx_spring,
    saturation as fx_saturation,
    tilt as fx_tilt,
)
from libgooey_tpu.engine import lfo as lfo_mod
from libgooey_tpu.engine.sequencer import Sequencer
from libgooey_tpu import music
from libgooey_tpu.instruments import bass, hihat, hihat2, kick, poly, snare, tom, tom2

#: Global-FX registry: name -> (module, default targets builder).
#: Order here is the default FFI effect order (saturation, LP, tilt, delay,
#: compressor, spring, plate; SoftLimiter pinned last — ffi.rs:1313-1372).
FX_MODULES = {
    "saturation": fx_saturation,
    "lowpass": fx_lowpass,
    "tilt": fx_tilt,
    "delay": fx_delay,
    "compressor": fx_compressor,
    "spring": fx_spring,
    "plate": fx_plate,
}

FX_DEFAULT_TARGETS = {
    "saturation": [0.3, 0.3, 1.0],
    "lowpass": [8000.0, 0.2],
    "tilt": [0.5, 0.0],
    "delay": [0.5, 0.3, 0.3, 8000.0],
    "compressor": [-20.0, 4.0, 10.0, 100.0, 1.0],
    "spring": [0.5, 0.3, 0.5],
    "plate": [0.5, 0.3, 0.5, 0.0, 1.0, 0.5],
}

#: Instrument family registry: kind -> module.  Every module implements
#: ``init_state(V, config)`` and ``render_block(state, off, vel, start,
#: sample_rate=, block_size=, smooth_coeff=, **static)`` plus PARAM_NAMES /
#: PARAM_INDEX / PRESETS.
FAMILIES = {
    "kick": kick,
    "snare": snare,
    "hihat": hihat,
    "hihat2": hihat2,
    "tom": tom,
    "tom2": tom2,
    "bass": bass,
    "poly": poly,
}

#: Event lanes per named instrument: poly allocates NUM_VOICES device lanes
#: per synth; all other families are one lane per instrument.
def _lanes_per_slot(kind: str) -> int:
    return poly.NUM_VOICES if kind == "poly" else 1


def _pack_triggers(pend: dict, V: int, B: int):
    """Pack per-voice trigger lists into event arrays.

    ``pend`` maps flat voice index -> list of ``(offset, velocity, freq)``.
    Returns ``(offs, vels, freqs)`` shaped ``[V]`` when no voice has more
    than one trigger this block (the common case — keeps the compiled
    single-trigger graphs hot), else ``[V, K]`` slot arrays with offsets
    ascending per voice and empty slots filled with ``B`` (= no trigger).
    A later trigger re-snapshots envelopes mid-block exactly like the
    reference's per-sample retrigger (ffi.rs:1152-1205).
    """
    K = max((len(v) for v in pend.values()), default=1) or 1
    if K == 1:
        offs = np.full(V, B, np.int32)
        vels = np.zeros(V, np.float32)
        freqs = np.zeros(V, np.float32)
        for flat, lst in pend.items():
            off, vel, freq = lst[0]
            offs[flat], vels[flat], freqs[flat] = off, vel, freq
        return offs, vels, freqs
    offs = np.full((V, K), B, np.int32)
    vels = np.zeros((V, K), np.float32)
    freqs = np.zeros((V, K), np.float32)
    for flat, lst in pend.items():
        # stable sort: same-offset triggers keep arrival order (last wins)
        for k, (off, vel, freq) in enumerate(sorted(lst, key=lambda t: t[0])):
            offs[flat, k], vels[flat, k], freqs[flat, k] = off, vel, freq
    return offs, vels, freqs

#: Per-family extra static kwargs for render_block.
FAMILY_STATIC = {
    "kick": dict(max_harmonics=128, feedback_path=False),
    "snare": dict(max_harmonics=192),
    "hihat": dict(),
    "hihat2": dict(),
    "tom": dict(max_harmonics=128),
    "tom2": dict(),
    "bass": dict(),
}


def _render_all(
    state: dict,
    events: dict,
    *,
    kinds: Tuple[str, ...],
    sample_rate: float,
    block_size: int,
    smooth_coeff: float,
    limiter_threshold: float,
    family_static: Tuple[Tuple[str, Tuple[Tuple[str, object], ...]], ...],
    lfo_routes: Tuple = (),
    fx_order: Tuple[str, ...] = (),
    sidechain_voice: int = -1,
    collect_sources: bool = False,
    psum_axis: Optional[str] = None,
):
    """One block over every instrument bank + mix + master + global FX.

    ``lfo_routes``: static tuple of (lfo_index, kind, slot, param, depth).
    ``fx_order``: static tuple of enabled global-effect names, applied in
    order on the stereo bus before the pinned soft limiter.
    ``sidechain_voice``: global voice index feeding the compressor detector
    (-1 = self-keyed), mirroring the FFI's per-instrument sidechain source.
    ``psum_axis``: under ``shard_map`` (``parallel.mesh.render_all_sharded``)
    this function runs per shard on LOCAL voice slices, and ``psum_axis``
    names the mesh axis to all-reduce the ``[2, B]`` mix over (SURVEY §2.10:
    the final additive mix is the only cross-voice communication).
    """
    static = {k: dict(v) for k, v in family_static}
    new_state = dict(state)

    def _global_rows(n_local):
        """Global row ids of a family bank's local rows.  Single device:
        identity.  Under shard_map each shard holds an equal slice of every
        family, so global row = local row + shard_index * local_size —
        this is what lets GLOBAL-voice-indexed features (LFO route slots,
        the sidechain tap) run inside the sharded program instead of
        forcing the GSPMD path."""
        rows = jnp.arange(n_local, dtype=jnp.int32)
        if psum_axis is not None:
            rows = rows + jax.lax.axis_index(psum_axis) * n_local
        return rows

    # --- LFO value trajectories (device-side, from host-carried phases) ------
    lfo_trajs = None
    if lfo_routes:
        n = jnp.arange(block_size, dtype=jnp.float32)
        lfo_trajs = events["lfo_offset"][:, None] + jnp.sin(
            2.0 * np.pi
            * (events["lfo_phase"][:, None] + n[None, :] * events["lfo_inc"][:, None])
        ) * events["lfo_amount"][:, None]          # [8, B]

    voice_outs = []
    for kind in kinds:
        mod = FAMILIES[kind]
        overrides = None
        kind_routes = [r for r in lfo_routes if r[1] == kind]
        if kind_routes:
            bank = state[kind].params
            overrides = {}
            routed_params = sorted({r[3] for r in kind_routes})
            for pname in routed_params:
                idx = mod.PARAM_INDEX[pname]
                tgt = jnp.broadcast_to(
                    bank.target[:, idx, None],
                    (bank.target.shape[0], block_size),
                )
                rows = _global_rows(bank.target.shape[0])
                for (li, _k, slot, rp, depth) in kind_routes:
                    if rp != pname:
                        continue
                    val = lfo_mod.bipolar_to_target(lfo_trajs[li] * depth)
                    # row-mask select == .at[slot].set, and stays correct
                    # per-shard (rows are GLOBAL ids)
                    tgt = jnp.where((rows == slot)[:, None], val[None, :], tgt)
                from libgooey_tpu.ops import scan as gscan

                overrides[pname] = gscan.onepole(
                    smooth_coeff, tgt, bank.current[:, idx]
                )
        extra = {}
        if kind == "poly":
            extra["trig_freq"] = events["poly_freq"]
            extra["release_offset"] = events["poly_rel"]
            if overrides is not None:
                overrides = {
                    k: jnp.repeat(v, poly.NUM_VOICES, axis=0)
                    for k, v in overrides.items()
                }
        if kind == "bass" and "bass_freq" in events:
            extra["note_freq"] = events["bass_freq"]
        bank_state, out = mod.render_block(
            state[kind],
            events[kind + "_off"],
            events[kind + "_vel"],
            events["block_start"],
            sample_rate=sample_rate,
            block_size=block_size,
            smooth_coeff=smooth_coeff,
            overrides=overrides,
            **extra,
            **static.get(kind, {}),
        )
        new_state[kind] = bank_state
        voice_outs.append(out)

    def _all_voices():
        """[sum V, B] concat — only materialized by the source scatter,
        which needs a single voice matrix.  The mix below accumulates per
        family instead, so the banks' outputs are never copied into one
        matrix."""
        return jnp.concatenate(voice_outs, axis=0) if voice_outs else jnp.zeros(
            (0, block_size), jnp.float32
        )

    def _voice_row(i):
        """Row ``i`` of the global voice matrix without the concat."""
        for out in voice_outs:
            if i < out.shape[0]:
                return out[i]
            i -= out.shape[0]
        raise IndexError(i)

    if collect_sources:
        all_voices = _all_voices()
        pan_bank, pan_traj = smooth_block(state["pan"], smooth_coeff, block_size)
        gain_bank, gain_traj = smooth_block(state["gain"], smooth_coeff, block_size)
        gl, gr = dsp.pan_gains(pan_traj)
        shaped = all_voices * gain_traj
        # panned per-voice stereo frames routed through a [S, V] matrix into
        # mixer-graph source buses (the FFI pipeline's scatter, ffi.rs:1301)
        panned = jnp.stack([shaped * gl, shaped * gr], axis=1)       # [V,2,B]
        sources = jnp.einsum("sv,vcb->scb", events["source_matrix"], panned,
                             precision=jax.lax.Precision.HIGHEST)
        if psum_axis is not None:
            sources = jax.lax.psum(sources, psum_axis)
        voice_peaks = jnp.max(jnp.abs(shaped), axis=-1)              # [V]
        new_state["pan"] = pan_bank
        new_state["gain"] = gain_bank
        return new_state, sources, all_voices, voice_peaks

    pan_bank, pan_slice = smooth_block_lazy(state["pan"], smooth_coeff, block_size)
    gain_bank, gain_slice = smooth_block_lazy(state["gain"], smooth_coeff, block_size)

    # per-family accumulation: each family's pan/gain/mix fuses into its
    # own bank epilogue, no [sum V, B] concat/relayout (see _all_voices).
    # Trajectories rebuild lazily per family slice (smooth_block_lazy):
    # the slices are disjoint so no work repeats, and XLA keeps the
    # rebuild in-register instead of round-tripping 4 full-bank [V, B]
    # trajectory arrays through HBM.
    def _mix_loop(pan_const: bool):
        def f(_):
            mixl = jnp.zeros(block_size, jnp.float32)
            mixr = jnp.zeros(block_size, jnp.float32)
            mono = jnp.zeros(block_size, jnp.float32)
            idx = 0
            for out in voice_outs:
                V = out.shape[0]
                if pan_const:
                    glv, grv = dsp.pan_gains(
                        state["pan"].target[idx:idx + V])
                    gl, gr = glv[:, None], grv[:, None]
                else:
                    gl, gr = dsp.pan_gains(pan_slice(idx, idx + V))
                shaped = out * gain_slice(idx, idx + V)
                mixl = mixl + jnp.sum(shaped * gl, axis=0)
                mixr = mixr + jnp.sum(shaped * gr, axis=0)
                mono = mono + jnp.sum(shaped, axis=0)
                idx += V
            return mixl, mixr, mono
        return f

    # Per-sample pan gains are two [V, B] transcendentals (the mix
    # reduce's dominant cost), but the settle
    # snap makes the pan trajectory EXACTLY equal to the target once
    # |delta * q| < eps at the block's first sample (|decayed| is
    # monotone decreasing, so settled-at-0 means settled all block).
    # Device-side branch: settled banks (the steady state — pan writes
    # are rare) mix with [V] per-lane gains, identical values by the
    # snap; unsettled blocks keep the exact per-sample path.
    _q = jnp.float32(1.0) - jnp.asarray(smooth_coeff, jnp.float32)
    pan_settled = jnp.all(
        jnp.abs((state["pan"].current - state["pan"].target) * _q)
        < SMOOTHER_SETTLE_EPS)
    mixl, mixr, mono_sum = jax.lax.cond(
        pan_settled, _mix_loop(True), _mix_loop(False), None)
    mix = jnp.stack([mixl, mixr], axis=0)

    if psum_axis is not None:
        # the only cross-voice communication in the whole engine: one
        # [2, B] + [B] all-reduce per block; the bus below then
        # runs replicated on every shard from identical post-psum inputs
        mix = jax.lax.psum(mix, psum_axis)
        mono_sum = jax.lax.psum(mono_sum, psum_axis)

    master_bank, master_traj = smooth_block(state["master"], smooth_coeff, block_size)
    bus = mix * master_traj[None, :]
    mono = mono_sum * master_traj

    # --- global FX chain (user-ordered; limiter pinned last) -------------------
    for fx_name in fx_order:
        sidechained = fx_name == "compressor" and sidechain_voice >= 0
        mod = FX_MODULES[fx_name]
        kw = {}
        if sidechained:
            if psum_axis is None:
                sc = _voice_row(sidechain_voice)   # static index resolution
            else:
                # the owning shard masks its row out; one [B] all-reduce
                # rides with the mix psum (the ONLY other cross-voice
                # traffic), and the compressor then runs replicated from
                # identical inputs on every shard
                sc = jnp.zeros(block_size, jnp.float32)
                remaining = sidechain_voice
                for vout in voice_outs:
                    Vl = vout.shape[0]
                    Vf = Vl * jax.lax.axis_size(psum_axis)
                    if 0 <= remaining < Vf:
                        mask = (_global_rows(Vl) == remaining).astype(
                            jnp.float32)
                        sc = jnp.einsum("v,vb->b", mask, vout,
                                        precision=jax.lax.Precision.HIGHEST)
                        break
                    remaining -= Vf
                sc = jax.lax.psum(sc, psum_axis)
            kw["sidechain"] = jnp.stack([sc, sc], axis=0)
        new_state["fx_" + fx_name], bus = mod.process_block(
            state["fx_" + fx_name], bus, events["fx_" + fx_name],
            sample_rate=sample_rate, **kw,
        )

    out = limiter.soft_limit(bus, limiter_threshold)
    mono = limiter.soft_limit(mono, limiter_threshold)

    new_state["pan"] = pan_bank
    new_state["gain"] = gain_bank
    new_state["master"] = master_bank
    return new_state, out, mono


# limiter_threshold is deliberately NOT here: it only feeds elementwise
# soft_limit math, and marking it static would retrace the whole engine
# for every distinct host-automated threshold value.
_STATIC_NAMES = (
    "kinds",
    "sample_rate",
    "block_size",
    "smooth_coeff",
    "family_static",
    "lfo_routes",
    "fx_order",
    "sidechain_voice",
    "collect_sources",
    "psum_axis",
)

_render_all_jit = jax.jit(_render_all, static_argnames=_STATIC_NAMES)


@partial(jax.jit, static_argnames=_STATIC_NAMES)
def render_many(state: dict, events_stacked: dict, **static):
    """Render N blocks in one XLA program (lax.scan over blocks).

    ``events_stacked`` carries a leading block axis on every event array.
    The offline/bench path: the host precomputes all sequencer events
    up-front in exact arithmetic; the render runs with zero per-block
    dispatch.  Returns ``(final_state, stereo[N, 2, B])``.
    """

    def step(st, ev):
        st2, out, _mono = _render_all(st, ev, **static)
        return st2, out

    # unroll=2: halves the per-iteration xs-slice / carry-copy overhead and
    # lets XLA schedule across adjacent blocks
    return jax.lax.scan(step, state, events_stacked, unroll=2)


class Engine:
    """Host control plane over the device-resident render graph.

    Mirrors the reference Engine API (src/engine/mod.rs:84-127): named
    instruments of any family, `add_sequencer`, `trigger`, master gain,
    per-instrument pan/gain — each named instrument occupying one voice lane
    of its family's bank.
    """

    def __init__(
        self,
        sample_rate: float = DEFAULT_SAMPLE_RATE,
        block_size: int = DEFAULT_BLOCK_SIZE,
        family_static: Optional[dict] = None,
    ):
        self.sample_rate = float(sample_rate)
        self.block_size = int(block_size)
        self.smooth_coeff = smoothing_coeff(self.sample_rate)
        self.limiter_threshold = 1.0
        self.family_static = {**FAMILY_STATIC, **(family_static or {})}

        # host mirrors
        self._names: Dict[str, Tuple[str, int]] = {}   # name -> (kind, slot)
        self._targets: Dict[str, List[np.ndarray]] = {k: [] for k in FAMILIES}
        self._configs: Dict[str, List[object]] = {k: [] for k in FAMILIES}
        self._dirty: Dict[str, bool] = {k: False for k in FAMILIES}
        self._pan: List[float] = []
        self._gain: List[float] = []
        self._mix_dirty = False
        self._master_target = 0.25   # engine/mod.rs default master gain
        self._master_dirty = False

        self.sequencers: List[Sequencer] = []
        self._trigger_queue: List = []
        self.sample_count = 0
        self._state: Optional[dict] = None  # built lazily at first render

        # LFO pool (8, ffi.rs:33) + routes
        self.lfos = [lfo_mod.LfoConfig() for _ in range(8)]
        self.lfo_routes: List[lfo_mod.LfoRoute] = []

        # global FX chain: ordered names + staged targets; limiter pinned last
        self.fx_order: List[str] = []
        self.fx_targets: Dict[str, np.ndarray] = {}
        self.fx_extra: Dict[str, dict] = {}   # e.g. delay pingpong, timing
        self.sidechain_source: Optional[str] = None

        # MIDI-out event queue with per-block sample offsets (ffi.rs:2146-2168)
        self.midi_out: List[Tuple[int, str, float]] = []

        # per-instrument X/Y preset blenders (ChannelBlender, ffi.rs:409-440)
        self.blenders: Dict[str, object] = {}
        self._snap_queue: List[Tuple[str, int]] = []

        # poly host voice allocator: per synth slot, per lane metadata
        self._poly_lanes: Dict[int, list] = {}
        self._poly_queue: List[Tuple[int, int, str, int, float]] = []
        self._poly_order = 0

    # --- instrument management --------------------------------------------------

    def add_instrument(self, name: str, kind: str, config=None) -> int:
        if self._state is not None:
            raise RuntimeError("add instruments before the first render")
        if kind not in FAMILIES:
            raise KeyError(f"unknown instrument family {kind!r}")
        mod = FAMILIES[kind]
        cfg = config if config is not None else mod.PRESETS["default"]()
        slot = len(self._targets[kind])
        self._targets[kind].append(cfg.as_array())
        self._configs[kind].append(cfg)
        self._names[name] = (kind, slot)
        # mixer strip slot (global voice order: family order, then slot)
        self._pan.append(0.5)
        self._gain.append(1.0)
        return slot

    def add_kick(self, name: str, config=None) -> int:
        return self.add_instrument(name, "kick", config)

    def instrument_kinds(self) -> Tuple[str, ...]:
        return tuple(k for k in FAMILIES if self._targets[k])

    def _global_voice_index(self, name: str) -> int:
        kind, slot = self._names[name]
        idx = 0
        for k in FAMILIES:
            if k == kind:
                return idx + slot
            idx += len(self._targets[k])
        raise KeyError(name)

    # --- parameters ----------------------------------------------------------------

    def set_param(self, name: str, param: str, value: float):
        """Smoothed normalized param target (the *_PARAM_* setter family)."""
        kind, slot = self._names[name]
        mod = FAMILIES[kind]
        self._targets[kind][slot][mod.PARAM_INDEX[param]] = value
        self._dirty[kind] = True
        if self._state is not None:
            self._stage_kind(kind)

    def get_param(self, name: str, param: str) -> float:
        """Round-trip getter (host mirror — realtime-safe, no device read)."""
        kind, slot = self._names[name]
        return float(self._targets[kind][slot][FAMILIES[kind].PARAM_INDEX[param]])

    def set_config(self, name: str, config):
        kind, slot = self._names[name]
        self._targets[kind][slot] = config.as_array()
        self._configs[kind][slot] = config
        self._dirty[kind] = True
        if self._state is not None:
            self._stage_kind(kind)

    def set_pan(self, name: str, pan: float):
        self._pan[self._global_voice_index(name)] = float(np.clip(pan, 0.0, 1.0))
        self._mix_dirty = True

    def set_gain(self, name: str, gain: float):
        self._gain[self._global_voice_index(name)] = max(float(gain), 0.0)
        self._mix_dirty = True

    def set_master_gain(self, gain: float):
        self._master_target = float(gain)
        self._master_dirty = True

    # --- control ----------------------------------------------------------------------

    def add_sequencer(self, seq: Sequencer):
        if seq.name not in self._names:
            raise KeyError(f"sequencer targets unknown instrument {seq.name!r}")
        self.sequencers.append(seq)

    def new_sequencer(self, name: str, bpm: float, steps: int = 16) -> Sequencer:
        seq = Sequencer(bpm, self.sample_rate, steps, name)
        self.add_sequencer(seq)
        return seq

    def trigger(self, name: str, velocity: float = 0.5, offset: int = 0):
        """Queue a trigger for the next block (ffi.rs:1078-1095).

        ``offset`` is the in-block sample offset; manual (host) triggers land
        at block start like the reference's atomics drain, sequenced triggers
        carry their exact sample offset (ffi.rs:1152-1205)."""
        self._trigger_queue.append((self._names[name], float(velocity), int(offset)))

    # --- LFOs (engine/lfo.rs; 8-LFO pool ffi.rs:33-67) ---------------------------

    def set_lfo(self, index: int, *, frequency_hz=None, division=None, bpm=None,
                amount=None, offset=None):
        cfg = self.lfos[index]
        if frequency_hz is not None:
            cfg.frequency_hz = frequency_hz
        if division is not None:
            cfg.division = division
            cfg.frequency_hz = None
        if bpm is not None:
            cfg.bpm = bpm
        if amount is not None:
            cfg.amount = amount
        if offset is not None:
            cfg.offset = offset

    def add_lfo_route(self, lfo_index: int, name: str, parameter: str,
                      depth: float = 1.0):
        """Route LFO → (instrument, param); max 16 routes/LFO (ffi.rs:34)."""
        if sum(1 for r in self.lfo_routes if r.lfo == lfo_index) >= 16:
            raise RuntimeError("route capacity exceeded (16 per LFO)")
        kind, _slot = self._names[name]
        if kind == "tom2":
            raise ValueError("tom2 is not modulatable (tom2.rs as_modulatable)")
        mod = FAMILIES[kind]
        if parameter not in mod.PARAM_INDEX:
            raise KeyError(parameter)
        self.lfo_routes.append(lfo_mod.LfoRoute(lfo_index, name, parameter, depth))

    def clear_lfo_routes(self, lfo_index: Optional[int] = None):
        self.lfo_routes = [
            r for r in self.lfo_routes if lfo_index is not None and r.lfo != lfo_index
        ]

    def _routes_static(self) -> Tuple:
        out = []
        for r in self.lfo_routes:
            kind, slot = self._names[r.instrument]
            out.append((r.lfo, kind, slot, r.parameter, float(r.depth)))
        return tuple(out)

    # --- global FX chain ----------------------------------------------------------

    def add_global_effect(self, name: str, targets=None, **extra):
        """Append a global effect (reorderable; SoftLimiter stays pinned last)."""
        if name not in FX_MODULES:
            raise KeyError(name)
        if name not in self.fx_order:
            self.fx_order.append(name)
        self.fx_targets[name] = np.asarray(
            targets if targets is not None else FX_DEFAULT_TARGETS[name], np.float32
        )
        self.fx_extra[name] = extra
        if self._state is not None and "fx_" + name not in self._state:
            self._state["fx_" + name] = FX_MODULES[name].init_state(self.sample_rate)

    def remove_global_effect(self, name: str):
        if name in self.fx_order:
            self.fx_order.remove(name)

    def set_effect_order(self, order: List[str]):
        """Reorder the chain (ffi effect_order; limiter pinned last)."""
        assert all(n in FX_MODULES for n in order)
        self.fx_order = [n for n in order if n in self.fx_targets]

    def set_effect_param(self, name: str, index: int, value: float):
        self.fx_targets[name][index] = value

    def get_effect_param(self, name: str, index: int) -> float:
        return float(self.fx_targets[name][index])

    def set_sidechain_source(self, name: Optional[str]):
        """Compressor detector keyed from an instrument (ffi sidechain)."""
        self.sidechain_source = name

    # --- poly note interface (poly_synth.rs trigger/release, FFI chord API) ------

    def _poly_allocate(self, slot: int, note: int) -> int:
        """Prefer an inactive lane, else steal the oldest (poly_synth.rs:421-434)."""
        lanes = self._poly_lanes.setdefault(
            slot, [dict(note=-1, order=-1, end=0) for _ in range(poly.NUM_VOICES)]
        )
        now = self.sample_count
        idx = next((i for i, l in enumerate(lanes) if l["end"] <= now), None)
        if idx is None:
            idx = min(range(poly.NUM_VOICES), key=lambda i: lanes[i]["order"])
        self._poly_order += 1
        cfg = self._targets["poly"][slot]
        sustain = cfg[poly.PARAM_INDEX["amp_sustain"]]
        a = 0.001 * 5000.0 ** cfg[poly.PARAM_INDEX["amp_attack"]]
        d = 0.001 * 5000.0 ** cfg[poly.PARAM_INDEX["amp_decay"]]
        end = 2**62 if sustain > 0.0 else now + int((a + d) * self.sample_rate) + 1
        lanes[idx].update(note=note, order=self._poly_order, end=end)
        return idx

    def poly_note_on(self, name: str, note: int, velocity: float = 1.0):
        kind, slot = self._names[name]
        assert kind == "poly", name
        lane = self._poly_allocate(slot, note)
        self._poly_queue.append((slot, lane, "on", int(note), float(velocity)))

    def poly_note_off(self, name: str, note: int):
        kind, slot = self._names[name]
        lanes = self._poly_lanes.get(slot, [])
        cfg = self._targets["poly"][slot]
        r = 0.001 * 5000.0 ** cfg[poly.PARAM_INDEX["amp_release"]]
        for lane, meta in enumerate(lanes):
            if meta["note"] == note and meta["end"] > self.sample_count:
                meta["end"] = self.sample_count + int(r * self.sample_rate) + 1
                self._poly_queue.append((slot, lane, "off", int(note), 0.0))

    def poly_release_all(self, name: str):
        kind, slot = self._names[name]
        for lane, meta in enumerate(self._poly_lanes.get(slot, [])):
            if meta["end"] > self.sample_count:
                self.poly_note_off(name, meta["note"])

    def poly_chord_on(self, name: str, root: str, quality: str = "major",
                      voicing: str = "root", octave: int = 4,
                      velocity: float = 1.0):
        """Chord interface via the music layer (FFI chord API)."""
        for note in music.apply_voicing(music.Chord(root, quality), voicing, octave):
            self.poly_note_on(name, note, velocity)

    def poly_chord_off(self, name: str, root: str, quality: str = "major",
                       voicing: str = "root", octave: int = 4):
        for note in music.apply_voicing(music.Chord(root, quality), voicing, octave):
            self.poly_note_off(name, note)

    # --- device state ---------------------------------------------------------------------

    def _build_state(self):
        state = {}
        for kind in self.instrument_kinds():
            mod = FAMILIES[kind]
            targets = np.stack(self._targets[kind])
            state[kind] = mod.init_state(len(self._targets[kind]), targets=targets)
            # non-smoothed static per-voice fields from configs
            if kind == "snare":
                state[kind] = state[kind]._replace(
                    filter_type=jnp.asarray(
                        [c.filter_type for c in self._configs[kind]], jnp.int32
                    )
                )
            if kind == "hihat":
                state[kind] = state[kind]._replace(
                    is_open=jnp.asarray(
                        [1.0 if c.is_open else 0.0 for c in self._configs[kind]],
                        jnp.float32,
                    )
                )
            if kind == "hihat2":
                state[kind] = state[kind]._replace(
                    noise_color=jnp.asarray(
                        [c.noise_color for c in self._configs[kind]], jnp.int32
                    ),
                    filter_slope=jnp.asarray(
                        [c.filter_slope for c in self._configs[kind]], jnp.int32
                    ),
                )
        state["pan"] = SmootherBank.init(np.asarray(self._pan, np.float32))
        state["gain"] = SmootherBank.init(np.asarray(self._gain, np.float32))
        state["master"] = SmootherBank.init(np.float32(self._master_target))
        for name in self.fx_order:
            state["fx_" + name] = FX_MODULES[name].init_state(self.sample_rate)
        self._state = state

    def _stage_kind(self, kind: str):
        if not self._dirty[kind] or self._state is None:
            return
        targets = np.stack(self._targets[kind])
        st = self._state[kind]
        if hasattr(st, "params") and isinstance(st.params, SmootherBank):
            bank = st.params.with_targets(targets)
            snaps = [s for k, s in self._snap_queue if k == kind]
            if snaps:
                cur = bank.current
                for slot in snaps:
                    cur = cur.at[slot].set(bank.target[slot])
                bank = SmootherBank(current=cur, target=bank.target)
                self._snap_queue = [e for e in self._snap_queue if e[0] != kind]
            self._state[kind] = st._replace(params=bank)
        else:  # tom2: plain params
            self._state[kind] = st._replace(params=jnp.asarray(targets, jnp.float32))
        self._dirty[kind] = False

    def _stage(self):
        if self._state is None:
            self._build_state()
        for kind in self.instrument_kinds():
            self._stage_kind(kind)
        if self._mix_dirty:
            self._state["pan"] = self._state["pan"].with_targets(
                np.asarray(self._pan, np.float32)
            )
            self._state["gain"] = self._state["gain"].with_targets(
                np.asarray(self._gain, np.float32)
            )
            self._mix_dirty = False
        if self._master_dirty:
            self._state["master"] = self._state["master"].with_targets(
                np.float32(self._master_target)
            )
            self._master_dirty = False

    def _collect_events(self) -> dict:
        B = self.block_size
        kinds = self.instrument_kinds()
        # Per-voice trigger LISTS: every trigger this block is kept, with its
        # exact sample offset (ffi.rs:1152-1205 applies each trigger at its
        # in-block position).  Packed below into [V] arrays (single-trigger
        # common case) or [V, K] slot arrays (multi-trigger blocks) — see
        # instruments/common.py VoiceBlock.
        pend = {k: {} for k in kinds}          # kind -> {flat: [(off, vel, freq)]}

        def add(kind, flat, off, vel, freq=0.0):
            pend[kind].setdefault(flat, []).append(
                (int(off), float(vel), float(freq))
            )

        poly_rel = (
            np.full(len(self._targets["poly"]) * poly.NUM_VOICES, B, np.int32)
            if "poly" in kinds else None
        )
        # drain poly note events (host voice allocation already chose lanes)
        for (slot, lane, kind_ev, note, velocity) in self._poly_queue:
            flat = slot * poly.NUM_VOICES + lane
            if kind_ev == "on":
                add("poly", flat, 0, velocity, music.midi_to_freq(note))
            else:
                poly_rel[flat] = 0
        self._poly_queue.clear()
        for (kind, slot), velocity, offset in self._trigger_queue:
            if kind == "poly":
                lane = self._poly_allocate(slot, 60)
                flat = slot * poly.NUM_VOICES + lane
                add(kind, flat, offset, velocity, music.midi_to_freq(60))
            else:
                add(kind, slot, offset, velocity)
        self._trigger_queue.clear()
        for seq in self.sequencers:
            kind, slot = self._names[seq.name]
            for trig in seq.tick_block(B):
                if kind == "poly":
                    note = trig.note if trig.note is not None else 60
                    lane = self._poly_allocate(slot, note)
                    flat = slot * poly.NUM_VOICES + lane
                    add(kind, flat, trig.offset, trig.velocity,
                        music.midi_to_freq(note))
                elif kind == "bass" and trig.note is not None:
                    # per-step note override sets the trigger frequency
                    add(kind, slot, trig.offset, trig.velocity,
                        music.midi_to_freq(trig.note))
                else:
                    add(kind, slot, trig.offset, trig.velocity)
                # per-step blend override: SNAP the voice to the blended
                # config (ffi.rs:1163-1205 snap_params on step blends)
                blender = self.blenders.get(seq.name)
                if trig.blend is not None and blender is not None:
                    cfg = blender.blend(*trig.blend)
                    self._targets[kind][slot] = cfg.as_array()
                    self._dirty[kind] = True
                    self._snap_queue.append((kind, slot))
                self.midi_out.append((self.sample_count + trig.offset, seq.name,
                                      trig.velocity))
        if len(self.midi_out) > 64:   # MIDI_EVENT_CAPACITY, silent overflow drop
            self.midi_out = self.midi_out[-64:]
        # events stay HOST-side (numpy): the jitted render converts at
        # dispatch, and the span planner stacks K blocks before one upload
        events = {"block_start": np.int32(self.sample_count)}
        for k in kinds:
            V = len(self._targets[k]) * _lanes_per_slot(k)
            offs, vels, freqs = _pack_triggers(pend[k], V, B)
            events[k + "_off"] = offs
            events[k + "_vel"] = vels
            if k == "poly":
                events["poly_freq"] = freqs
                events["poly_rel"] = poly_rel
            elif k == "bass":
                events["bass_freq"] = freqs
        if self.lfo_routes:
            phases, incs, amounts, offsets = [], [], [], []
            for cfg in self.lfos:
                phases.append(cfg.advance(B, self.sample_rate))
                incs.append(cfg.freq() / self.sample_rate)
                amounts.append(cfg.amount if cfg.enabled else 0.0)
                offsets.append(cfg.offset)
            events["lfo_phase"] = np.array(phases, np.float32)
            events["lfo_inc"] = np.array(incs, np.float32)
            events["lfo_amount"] = np.array(amounts, np.float32)
            events["lfo_offset"] = np.array(offsets, np.float32)
        for name in self.fx_order:
            events["fx_" + name] = np.asarray(self.fx_targets[name])
        return events

    def drain_midi_out(self):
        """Host MIDI-out drain (ffi.rs:2146-2168): (sample, name, velocity)."""
        out = self.midi_out
        self.midi_out = []
        return out

    def _static_key(self):
        return tuple(
            (k, tuple(sorted(self.family_static.get(k, {}).items())))
            for k in self.instrument_kinds()
        )

    # --- rendering ---------------------------------------------------------------------------

    def render_block(self):
        """Render one block → ``(stereo[2,B], mono[B])`` device arrays."""
        self._stage()
        events = self._collect_events()
        self._stage()  # per-step blends may have re-dirtied targets
        sc_voice = (
            self._global_voice_index(self.sidechain_source)
            if self.sidechain_source is not None
            else -1
        )
        self._state, out, mono = _render_all_jit(
            self._state,
            events,
            kinds=self.instrument_kinds(),
            sample_rate=self.sample_rate,
            block_size=self.block_size,
            smooth_coeff=self.smooth_coeff,
            limiter_threshold=self.limiter_threshold,
            family_static=self._static_key(),
            lfo_routes=self._routes_static(),
            fx_order=tuple(self.fx_order),
            sidechain_voice=sc_voice,
        )
        self.sample_count += self.block_size
        return out, mono

    def render(self, num_samples: int) -> np.ndarray:
        blocks = []
        rendered = 0
        while rendered < num_samples:
            out, _ = self.render_block()
            blocks.append(np.asarray(out))
            rendered += self.block_size
        return np.concatenate(blocks, axis=1)[:, :num_samples]

    def render_mono(self, num_samples: int) -> np.ndarray:
        """Mono (unpanned sum) — the reference's bounce path (mod.rs:400-415)."""
        blocks = []
        rendered = 0
        while rendered < num_samples:
            _, mono = self.render_block()
            blocks.append(np.asarray(mono))
            rendered += self.block_size
        return np.concatenate(blocks)[:num_samples]

    # --- bounce (src/bounce.rs) -----------------------------------------------------------------

    def prepare_for_bounce(self):
        """Reset sequencers/transport and snap master gain (mod.rs:464-477)."""
        for seq in self.sequencers:
            seq.reset()
        self._stage()
        self._state["master"] = self._state["master"].snapped()
        self.sample_count = 0

    def bounce_samples_for(self, bpm: float, bars: Optional[int] = None,
                           beats: Optional[float] = None,
                           samples: Optional[int] = None) -> int:
        """BounceLength::{Bars,Beats,Samples} → samples (bounce.rs:9-33)."""
        if samples is not None:
            return int(samples)
        if beats is None:
            beats = (bars or 0) * 4.0
        return int(beats * (60.0 / bpm) * self.sample_rate)

    def bounce_to_buffer(self, num_samples: int) -> np.ndarray:
        self.prepare_for_bounce()
        for seq in self.sequencers:
            seq.start()
        out = self.render_mono(num_samples)
        for seq in self.sequencers:
            seq.stop()
        return out

    def bounce_to_wav(self, path, num_samples: int, bits: int = 16):
        from libgooey_tpu.io_wav import write_wav

        buf = self.bounce_to_buffer(num_samples)
        write_wav(path, buf, int(self.sample_rate), bits=bits)
        return buf
