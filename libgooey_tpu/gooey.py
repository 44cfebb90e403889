"""GooeyEngine: the full product engine behind the `gooey_engine_*` C API.

Behavioral reference: src/ffi.rs (8,048 LoC) — the engine the iOS host
drives: a DrumKit of 4 hot-swappable VoiceStrips + a bass strip (VoiceStrip
= instrument + own sequencer + X/Y blender + gain/mute/solo/pan + peak +
pending triggers, ffi.rs:594-658), PolySynth, Granulator, the loop Mixer
(+ ClipGrid), a MixerGraph, up to 4 sampler racks, a PerformanceRecorder,
9 reorderable global effects with a pinned SoftLimiter, 8 LFOs × 16 routes,
and a terminal error latch (panic → silence + error callback,
ffi.rs:2086-2122).

The per-sample FFI pipeline (ffi.rs:1043-1380) runs here per block:
sequencers → triggers (blend/note overrides) → performance clip replay →
LFO routes → instrument banks → source frames → sampler racks + loop mixer
→ mixer graph → master gain → global FX chain → limiter.

Hot-swapping (INSTRUMENT_* 0-4): every channel pre-allocates one voice in
*each* family bank; swapping flips which voice is triggered/routed — no
state rebuild, no recompilation.
"""

from __future__ import annotations

import functools
import traceback
from typing import Dict, List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from libgooey_tpu import music
from libgooey_tpu.core.blendable import PresetBlender
from libgooey_tpu.core.smoother import SmootherBank, smoothing_coeff
from libgooey_tpu.engine import engine as eng
from libgooey_tpu.engine.engine import FAMILIES, Engine
from libgooey_tpu.engine.sequencer import Sequencer
from libgooey_tpu.instruments import granulator as gran_mod
from libgooey_tpu.instruments import poly as poly_mod
from libgooey_tpu.instruments import sampler as samp_mod
from libgooey_tpu.mixer import chain as chain_mod
from libgooey_tpu.mixer import graph as graph_mod
from libgooey_tpu.mixer.mixer import Mixer
from libgooey_tpu.performance import PerformanceRecorder

# INSTRUMENT_* ids (ffi.rs:1843-1851)
INSTRUMENT_KICK, INSTRUMENT_SNARE, INSTRUMENT_HIHAT, INSTRUMENT_TOM, INSTRUMENT_BASS = range(5)
INSTRUMENT_KINDS = ("kick", "snare", "hihat2", "tom2", "bass")

NUM_KIT_CHANNELS = 4
SAMPLER_RACK_MAX = 4

def _fx_flag(ent) -> bool:
    """Trace-static per-entry flag (see chain.EffectChain.static_key)."""
    if ent.effect_id == chain_mod.EFFECT_DELAY:
        return bool(ent.pingpong)
    if ent.effect_id == chain_mod.EFFECT_FEEDBACK_WAVESHAPER:
        return float(ent.targets[1]) == 0.0
    return False


def _fx_chain_block(states, bus, targets, key, sidechain, limiter_threshold,
                    *, sample_rate, limiter_enabled):
    """Fold the enabled global-FX chain + soft limiter over one block.

    Jitted as ONE function (static ``key``) so the product render path
    dispatches a single computation for the whole bus section instead of
    hundreds of eager ops per block (ffi.rs:1313-1372 order semantics).
    """
    from libgooey_tpu.effects import limiter as lim

    new_states = []
    for (eid, flag), st, tg in zip(key, states, targets):
        kw = {}
        if eid == chain_mod.EFFECT_COMPRESSOR and sidechain is not None:
            kw["sidechain"] = sidechain
        st, bus = chain_mod.process_entry(
            eid, st, bus, tg, sample_rate=sample_rate, pingpong=flag, **kw
        )
        new_states.append(st)
    if limiter_enabled:
        # threshold is a TRACED operand: host automation of the limiter
        # threshold must not retrace the whole bus chain (it only feeds
        # elementwise soft_limit math)
        bus = lim.soft_limit(bus, limiter_threshold)
    return tuple(new_states), bus


import functools as _functools
import jax as _jax

_fx_chain_jit = _jax.jit(
    _fx_chain_block,
    static_argnames=("key", "sample_rate", "limiter_enabled"),
)
DEFAULT_CHANNEL_KINDS = ("kick", "snare", "hihat2", "tom2")


@_functools.partial(_jax.jit, static_argnames=(
    "kinds", "sample_rate", "block_size", "smooth_coeff", "family_static",
    "lfo_routes", "fx_key", "limiter_enabled", "rack_slots", "graph_rack_keys", "graph_coeff", "sidechain_voice"))
def _span_render(carry, consts, xs, *, kinds, sample_rate, block_size,
                 smooth_coeff, family_static, lfo_routes, fx_key,
                 limiter_enabled, rack_slots,
                 graph_rack_keys, graph_coeff, sidechain_voice):
    """K product blocks as ONE device program (lax.scan over blocks).

    The scanned step is the device half of ``GooeyEngine._render_one_block``
    — instruments (ffi.rs:1043-1380 order) → granulator → loop mixer (its
    pre-rendered ``[K, 2, B]`` stream rides in ``xs``) → sampler racks →
    mixer graph → master → global FX → limiter — with the host half
    (sequencers, perf clock, param staging) pre-planned into per-block
    events by ``GooeyEngine._plan_span``.  Host param mutations that the
    per-block path applies between dispatches (blend snaps, per-step note
    overrides + restores) arrive as per-block ``stage_tgt``/``stage_snap``
    events, exactly mirroring ``Engine._stage_kind``.  One dispatch per
    span amortizes the dispatch floor K× (the realtime budget
    engine_output.rs:305-311 is per block; the span is how an offline or
    lookahead host render meets it).
    """
    from libgooey_tpu.core.smoother import smooth_block

    sqrt_half = np.float32(np.sqrt(0.5))

    def step(c, x):
        e_state = dict(c["engine"])
        # param staging (Engine._stage_kind semantics, per block)
        for kind in kinds:
            st = e_state[kind]
            tgt = x["stage_tgt"][kind]
            if isinstance(getattr(st, "params", None), SmootherBank):
                bank = st.params.with_targets(tgt)
                snap = x["stage_snap"][kind][:, None]
                cur = jnp.where(snap, bank.target, bank.current)
                e_state[kind] = st._replace(
                    params=SmootherBank(current=cur, target=bank.target))
            else:  # tom2: plain (unsmoothed) params
                e_state[kind] = st._replace(params=tgt)
        e_state["pan"] = e_state["pan"].with_targets(x["pan_tgt"])
        e_state["gain"] = e_state["gain"].with_targets(x["gain_tgt"])

        ev = dict(x["ev"])
        ev["source_matrix"] = consts["source_matrix"]
        e_state, sources, all_voices, voice_peaks = eng._render_all(
            e_state, ev, kinds=kinds, sample_rate=sample_rate,
            block_size=block_size, smooth_coeff=smooth_coeff,
            limiter_threshold=1.0, family_static=family_static,
            lfo_routes=lfo_routes, fx_order=(), sidechain_voice=-1,
            collect_sources=True,
        )
        bs = ev["block_start"]

        gran_state, gout = gran_mod.render_block(
            c["gran"], x["gran"], bs, sample_rate=sample_rate,
            block_size=block_size, smooth_coeff=smooth_coeff,
        )
        sources = sources.at[graph_mod.SOURCE_GRANULATOR].set(
            jnp.stack([gout * sqrt_half, gout * sqrt_half]))
        sources = sources.at[graph_mod.SOURCE_LOOPMIXER].set(x["loop_out"])

        rack_states = []
        for i, slot in enumerate(rack_slots):
            rs, rout = samp_mod.render_block(
                c["racks"][i], x["racks"][i], bs, sample_rate=sample_rate,
                block_size=block_size,
            )
            rack_states.append(rs)
            sources = sources.at[graph_mod.SOURCE_SAMPLER_BASE + slot].set(rout)

        gbank, gracks, master_bus, gpeaks = graph_mod.graph_block(
            c["gbank"], consts["graph_targets"], sources,
            consts["graph_routing"], c["gracks"], consts["graph_rack_targets"],
            coeff=graph_coeff, block_size=block_size, sample_rate=sample_rate,
            rack_keys=graph_rack_keys,
        )

        master, mtraj = smooth_block(c["master"], smooth_coeff, block_size)
        bus = master_bus * mtraj[None, :]
        sidechain = None
        if sidechain_voice >= 0:
            sc = all_voices[sidechain_voice]
            sidechain = jnp.stack([sc, sc], axis=0)
        fx_states, bus = _fx_chain_block(
            c["fx"], bus, consts["fx_targets"], fx_key, sidechain,
            consts["limiter_threshold"], sample_rate=sample_rate,
            limiter_enabled=limiter_enabled,
        )

        c2 = dict(
            engine=e_state, gran=gran_state, racks=tuple(rack_states),
            fx=fx_states, master=master, gbank=gbank, gracks=gracks,
            strip_peak=jnp.maximum(
                c["strip_peak"], voice_peaks[consts["strip_idx"]]),
            graph_peak=jnp.maximum(c["graph_peak"], gpeaks),
        )
        return c2, bus

    return jax.lax.scan(step, carry, xs)


class GooeyEngine:
    def __init__(self, sample_rate: float = 44100.0, block_size: int = 512):
        self.sr = float(sample_rate)
        self.block = int(block_size)
        self.bpm = 120.0
        self.error: Optional[str] = None
        self.error_callback = None
        self.sample_count = 0

        # instrument layer: 4 kit channels × 5 kinds + dedicated bass strip
        self.engine = Engine(sample_rate, block_size)
        for ch in range(NUM_KIT_CHANNELS):
            for kind in INSTRUMENT_KINDS:
                self.engine.add_instrument(f"ch{ch}_{kind}", kind)
        self.engine.add_instrument("bass", "bass")
        self.channel_kind: List[str] = list(DEFAULT_CHANNEL_KINDS)

        # strip control (sequencer + blender + mixer strip per kit channel + bass)
        self.sequencers: List[Sequencer] = [
            Sequencer(self.bpm, self.sr, 16, f"strip{c}") for c in range(NUM_KIT_CHANNELS + 1)
        ]
        self.blenders: List[Optional[PresetBlender]] = [None] * (NUM_KIT_CHANNELS + 1)
        self.blend_enabled = [False] * (NUM_KIT_CHANNELS + 1)
        self.blend_pos = [(0.5, 0.5)] * (NUM_KIT_CHANNELS + 1)
        self.blend_corner_ids = [[0, 0, 0, 0] for _ in range(NUM_KIT_CHANNELS + 1)]
        self.link_enabled = False
        self.render_host_time = 0.0
        self.strip_gain = np.ones(NUM_KIT_CHANNELS + 1, np.float32)
        self.strip_pan = np.full(NUM_KIT_CHANNELS + 1, 0.5, np.float32)
        self.strip_mute = np.zeros(NUM_KIT_CHANNELS + 1, bool)
        self.strip_solo = np.zeros(NUM_KIT_CHANNELS + 1, bool)
        self.strip_peak = np.zeros(NUM_KIT_CHANNELS + 1, np.float32)
        #: device-side per-strip peak accumulator: the render loop folds each
        #: block's voice peaks in WITHOUT a host sync (the round-1 path pulled
        #: voice_peaks to the host every block, serializing the pipeline);
        #: take_strip_peak() drains it lazily on the host query.
        self._strip_peak_dev = jnp.zeros(NUM_KIT_CHANNELS + 1, jnp.float32)
        self._strip_voice_idx: Optional[np.ndarray] = None
        self._pending_triggers: List = []   # (strip, velocity)
        self._post_restore: List = []       # (name, pname, saved) note restores

        # poly / granulator / loops / racks / graph / performance
        self.engine.add_instrument("poly", "poly")
        gr_buf = np.zeros(1024, np.float32)
        self.gran_host = gran_mod.GranulatorHost(self.sr, gr_buf, self.sr)
        self.gran_state = gran_mod.init_state(gr_buf, self.sr)
        # FFI buffer contract (tests/ffi_granulator.rs:26-37): reported length
        # is 1 — "no host buffer loaded yet" — until set_buffer succeeds; the
        # 1024-zero device placeholder is an internal detail (it keeps the
        # grain-read kernels' window math away from degenerate 1-sample
        # tables while rendering silence either way).
        self.gran_buffer_len = 1
        self.gran_buffer_sr = float(self.sr)
        self.mixer = Mixer(self.sr, self.bpm, self.block)
        self.graph = graph_mod.MixerGraph.with_default_layout(self.sr, self.bpm)
        self.racks: List[Optional[samp_mod.SamplerRackHost]] = [None] * SAMPLER_RACK_MAX
        self.rack_states: List[Optional[samp_mod.SamplerState]] = [None] * SAMPLER_RACK_MAX
        self.performance = PerformanceRecorder()
        self.perf_chord_target = "poly"
        self._perf_sounding = None

        # global FX: reorderable chain entries + enabled flags; limiter pinned
        self.fx = chain_mod.EffectChain(self.sr, self.bpm)
        for eid in (
            chain_mod.EFFECT_SATURATION, chain_mod.EFFECT_LOWPASS_FILTER,
            chain_mod.EFFECT_TILT_FILTER, chain_mod.EFFECT_DELAY,
            chain_mod.EFFECT_COMPRESSOR, chain_mod.EFFECT_WAVESHAPER,
            chain_mod.EFFECT_FEEDBACK_WAVESHAPER, chain_mod.EFFECT_REVERB,
            chain_mod.EFFECT_PLATE_REVERB,
        ):
            self.fx.add(eid)
        self.fx_enabled: Dict[int, bool] = {e.effect_id: False for e in self.fx.entries}
        self.limiter_enabled = True
        self.limiter_threshold = 1.0
        self.sidechain_strip: Optional[int] = None
        self.master = SmootherBank.init(np.float32(1.0))
        self.midi_out: List = []

        self._smooth_coeff = smoothing_coeff(self.sr)
        self._source_matrix = None
        #: multi-block `render(frames)` calls go through the planned-span
        #: scan (one device dispatch for K blocks); tests/benches can force
        #: the per-block path by clearing this
        self.span_rendering = True

        # Jitted per-block instrument programs.  render_block functions are
        # plain traceable fns; calling them EAGERLY here would run the
        # granulator op by op.  One jit per engine instance.
        self._gran_render = jax.jit(functools.partial(
            gran_mod.render_block, sample_rate=self.sr, block_size=self.block,
            smooth_coeff=self._smooth_coeff,
        ))
        self._rack_render = jax.jit(functools.partial(
            samp_mod.render_block, sample_rate=self.sr, block_size=self.block,
        ))

    # --- naming helpers ----------------------------------------------------------

    def _strip_name(self, strip: int) -> str:
        if strip < NUM_KIT_CHANNELS:
            return f"ch{strip}_{self.channel_kind[strip]}"
        return "bass"

    def set_channel_instrument(self, channel: int, instrument_id: int) -> bool:
        """Hot-swap a kit channel's instrument (ffi.rs:2290-2335)."""
        if not (0 <= channel < NUM_KIT_CHANNELS) or not (0 <= instrument_id < 5):
            return False
        self.channel_kind[channel] = INSTRUMENT_KINDS[instrument_id]
        self._source_matrix = None
        return True

    def get_channel_instrument(self, channel: int) -> int:
        return INSTRUMENT_KINDS.index(self.channel_kind[channel])

    # --- params / triggers ---------------------------------------------------------

    def set_param(self, strip: int, param: str, value: float):
        self.engine.set_param(self._strip_name(strip), param, value)

    def get_param(self, strip: int, param: str) -> float:
        return self.engine.get_param(self._strip_name(strip), param)

    def trigger_channel(self, strip: int, velocity: float = 0.5):
        """Queued like the FFI's atomics, drained at sample 0 (ffi.rs:1078)."""
        self._pending_triggers.append((strip, float(velocity)))

    def set_blender(self, strip: int, blender: PresetBlender):
        self.blenders[strip] = blender

    def blend_to(self, strip: int, x: float, y: float):
        """Apply the X/Y pad blend immediately (snap, ffi ChannelBlender)."""
        b = self.blenders[strip]
        if b is None:
            return False
        name = self._strip_name(strip)
        kind, slot = self.engine._names[name]
        self.engine._snap_queue.append((kind, slot))  # before the setter (see blend steps)
        self.engine.set_config(name, b.blend(x, y))
        self.blend_pos[strip] = (float(x), float(y))
        return True

    # --- transport / BPM ---------------------------------------------------------------

    def set_bpm(self, bpm: float):
        self.bpm = float(bpm)
        for seq in self.sequencers:
            seq.set_bpm(bpm)
        self.mixer.set_bpm(bpm)
        self.fx.set_bpm(bpm)
        for rack in self.racks:
            if rack:
                rack.sequencer.set_bpm(bpm)

    def transport_beat(self) -> float:
        return self.mixer.clip_grid.transport_beat

    def transport_start(self):
        self.mixer.clip_grid.transport_start(self.mixer.channels)

    def transport_stop(self):
        self.mixer.clip_grid.transport_stop(self.mixer.channels)

    # --- sampler racks ---------------------------------------------------------------------

    def register_sampler_rack(self, index: int, arena_frames: int = 1 << 20) -> bool:
        if not (0 <= index < SAMPLER_RACK_MAX):
            return False
        self.racks[index] = samp_mod.SamplerRackHost(
            self.sr, self.bpm, f"rack{index}", arena_frames
        )
        self.rack_states[index] = samp_mod.init_state(arena_frames)
        return True

    def sampler_trigger(self, rack: int, slot: int, velocity: float,
                        from_playback: bool = False) -> bool:
        r = self.racks[rack]
        if r is None:
            return False
        ok = r.trigger(slot, velocity)
        if ok and not from_playback:
            self.performance.record_sampler_hit(rack, slot, velocity)
        return ok

    # --- granulator --------------------------------------------------------------------------

    def granulator_load(self, samples: np.ndarray, sample_rate: float):
        buf = np.asarray(samples, np.float32)
        self.gran_buffer_len = int(buf.shape[-1])
        self.gran_buffer_sr = float(sample_rate)
        old_cfg = self.gran_host.cfg
        self.gran_host = gran_mod.GranulatorHost(
            self.sr, buf, sample_rate, seed=self.gran_host.rng.state
        )
        self.gran_host.cfg = old_cfg  # loading a buffer keeps the knob state
        self.gran_state = gran_mod.init_state(buf, sample_rate)._replace(
            params=self.gran_state.params
        )

    def granulator_set_param(self, name: str, value: float):
        self.gran_host.set_param(name, value)
        idx = gran_mod.PARAM_INDEX[name]
        tgt = np.array(self.gran_state.params.target)  # copy: jax views are read-only
        tgt[idx] = np.clip(value, 0.0, 1.0)
        self.gran_state = self.gran_state._replace(
            params=self.gran_state.params.with_targets(tgt)
        )

    def granulator_trigger(self, velocity: float = 1.0):
        self.gran_host.trigger(self.sample_count / self.sr, velocity)

    # --- performance recorder ------------------------------------------------------------------

    def perf_chord_on(self, root: int, scale_type: int, degree: int, voicing: int,
                      preset: int, octave: int, velocity: float):
        self._apply_chord(root, scale_type, degree, voicing, preset, octave,
                          velocity)
        self.performance.record_chord_on(
            root, scale_type, degree, voicing, preset, octave, velocity
        )

    def perf_chord_off(self):
        self._release_chord()
        self.performance.record_chord_off()

    def _apply_chord(self, root, scale_type, degree, voicing, preset, octave,
                     velocity):
        """Trigger a diatonic-seventh chord (ffi.rs:5571-5621): apply the poly
        preset as smoothed targets (no snap — snapping clicks while voices
        release), release sounding notes, then trigger the voiced chord."""
        from libgooey_tpu.instruments import poly as poly_mod

        names = ("default", "pad", "pluck", "keys", "strings")
        name = names[preset] if 0 <= int(preset) < len(names) else "default"
        self.engine.set_config(self.perf_chord_target, poly_mod.PRESETS[name]())
        key = music.Key(
            music.NOTE_NAMES[root % 12],
            "major" if scale_type == 0 else "natural_minor",
        )
        chord = key.diatonic_sevenths()[degree % 7]
        octave = min(max(int(octave), 0), 8)
        notes = music.apply_voicing(chord, music.VOICINGS[voicing % len(music.VOICINGS)],
                                    octave)
        self._release_chord()
        self._perf_sounding = notes
        for n in notes:
            self.engine.poly_note_on(self.perf_chord_target, n,
                                     min(max(velocity, 0.0), 1.0))

    def _release_chord(self):
        if self._perf_sounding:
            for n in self._perf_sounding:
                self.engine.poly_note_off(self.perf_chord_target, n)
            self._perf_sounding = None

    # --- global FX -----------------------------------------------------------------------------

    def set_effect_enabled(self, effect_id: int, enabled: bool):
        if effect_id == chain_mod.EFFECT_LIMITER:
            self.limiter_enabled = enabled
        else:
            self.fx_enabled[effect_id] = bool(enabled)

    def set_effect_param(self, effect_id: int, param: int, value: float) -> bool:
        for i, e in enumerate(self.fx.entries):
            if e.effect_id == effect_id:
                return self.fx.set_param(i, param, value)
        return False

    def get_effect_param(self, effect_id: int, param: int) -> float:
        for i, e in enumerate(self.fx.entries):
            if e.effect_id == effect_id:
                return self.fx.get_param(i, param)
        raise KeyError(effect_id)

    def set_effect_order(self, order: List[int]) -> bool:
        """Reorder the 9 reorderable effects (limiter pinned last)."""
        if sorted(order) != sorted(e.effect_id for e in self.fx.entries):
            return False
        by_id = {e.effect_id: (e, s) for e, s in zip(self.fx.entries, self.fx.states)}
        self.fx.entries = [by_id[i][0] for i in order]
        self.fx.states = [by_id[i][1] for i in order]
        return True

    # --- source routing ----------------------------------------------------------------------------

    def _build_source_matrix(self) -> np.ndarray:
        """[SOURCE_CAPACITY, V_total] matrix: strips → drumkit/bass, poly →
        polysynth source; granulator/loops/racks enter separately."""
        total = sum(
            len(self.engine._targets[k]) * eng._lanes_per_slot(k)
            for k in self.engine.instrument_kinds()
        )
        # voice rows in engine order; but mixer strips count = named slots
        n_named = sum(len(self.engine._targets[k]) for k in self.engine.instrument_kinds())
        m = np.zeros((graph_mod.SOURCE_CAPACITY, n_named), np.float32)
        for ch in range(NUM_KIT_CHANNELS):
            idx = self.engine._global_voice_index(self._strip_name(ch))
            m[graph_mod.SOURCE_DRUMKIT, idx] = 1.0
        m[graph_mod.SOURCE_BASS, self.engine._global_voice_index("bass")] = 1.0
        m[graph_mod.SOURCE_POLYSYNTH, self.engine._global_voice_index("poly")] = 1.0
        return m

    def _stage_strip_gating(self):
        """Stage strip mixer settings into engine pan/gain (solo-aware);
        gates INACTIVE kit instruments of each channel to zero.  Idempotent
        — runs at the top of every block (and once before a span's state
        build so the first `_build_state` starts from gated values exactly
        like the per-block path)."""
        e = self.engine
        any_solo = bool(self.strip_solo.any())
        for strip in range(NUM_KIT_CHANNELS + 1):
            audible = (not self.strip_mute[strip]) and (
                (not any_solo) or self.strip_solo[strip]
            )
            for kind in INSTRUMENT_KINDS:
                nm = f"ch{strip}_{kind}" if strip < NUM_KIT_CHANNELS else None
                if nm and nm in e._names:
                    active = kind == self.channel_kind[strip]
                    e.set_gain(nm, self.strip_gain[strip]
                               if (active and audible) else 0.0)
                    e.set_pan(nm, float(self.strip_pan[strip]))
            if strip == NUM_KIT_CHANNELS:
                e.set_gain("bass", self.strip_gain[strip] if audible else 0.0)
                e.set_pan("bass", float(self.strip_pan[strip]))
        e.set_gain("poly", 1.0)
        e.set_pan("poly", 0.5)  # poly is center-panned (ffi.rs:1291)

    # --- the render pipeline (ffi.rs:1043-1380) ------------------------------------------------------

    def render(self, frames: int) -> np.ndarray:
        """Render interleaved stereo ``[frames*2]`` like gooey_engine_render.

        On an internal error the engine latches a terminal error state and
        outputs silence forever (ffi.rs:2086-2122)."""
        if self.error is not None:
            return np.zeros(frames * 2, np.float32)
        try:
            out = self._render_blocks(frames)
            return out.T.reshape(-1)
        except Exception as exc:  # the catch_unwind panic fence
            self.error = f"{exc}\n{traceback.format_exc()}"
            if self.error_callback:
                try:
                    self.error_callback(str(exc))
                except Exception:
                    pass
            return np.zeros(frames * 2, np.float32)

    def _render_blocks(self, frames: int) -> np.ndarray:
        # Multi-block renders go through the planned-span scan: ONE device
        # dispatch for all K blocks (ffi.rs:2067 renders arbitrary `frames`
        # in one call).
        K = (frames + self.block - 1) // self.block
        if K >= 2 and self.span_rendering:
            return np.asarray(self._render_span(K))[:, :frames]
        # single block (or span disabled): dispatch every block before
        # materializing any — JAX dispatch is async, so host event prep for
        # block N+1 overlaps device compute for block N (the interactive
        # pipelining engine_output.rs:293-311 gets from its callback split)
        outs = []
        rendered = 0
        while rendered < frames:
            outs.append(self._render_one_block())
            rendered += self.block
        return np.concatenate([np.asarray(o) for o in outs], axis=-1)[:, :frames]

    # --- planned-span render (one scanned dispatch for K blocks) ----------------

    def _plan_host_block(self, beat: float, running: bool):
        """Host half of `_render_one_block` for ONE planned block.

        Mirrors steps 2-5 + strip gating of `_render_one_block` exactly
        (same call order, same queues); the engine param mutations it
        triggers land in the block's stage snapshot instead of in
        `engine._state` (the caller holds `engine._state = None` so the
        eager `_stage_kind` is inert).  Returns the block's event dict +
        stage/gran/rack event snapshots.  test_gooey_span pins this
        against the per-block path sample-for-sample.
        """
        B = self.block
        e = self.engine

        for rack in self.racks:
            if rack:
                rack.activate_start_if_due(beat)

        for strip, seq in enumerate(self.sequencers):
            name = self._strip_name(strip)
            kind, slot = e._names[name]
            for trig in seq.tick_block(B):
                if trig.blend is not None and self.blenders[strip] is not None:
                    cfg = self.blenders[strip].blend(*trig.blend)
                    e._snap_queue.append((kind, slot))
                    e.set_config(name, cfg)
                if trig.note is not None and kind != "bass":
                    mod = FAMILIES[kind]
                    pname = mod.PARAM_NAMES[0]
                    saved = e.get_param(name, pname)
                    freq = music.midi_to_freq(trig.note)
                    lo, hi = getattr(mod, "FREQ_RANGE", (30.0, 120.0))
                    e._snap_queue.append((kind, slot))
                    e.set_param(name, pname,
                                float(np.clip((freq - lo) / (hi - lo), 0, 1)))
                    e._trigger_queue.append(((kind, slot), trig.velocity,
                                             trig.offset))
                    if not any(n == name and p == pname
                               for n, p, _ in self._post_restore):
                        self._post_restore.append((name, pname, saved))
                else:
                    e._trigger_queue.append(((kind, slot), trig.velocity,
                                             trig.offset))
                if len(self.midi_out) < 64:
                    self.midi_out.append((self.sample_count + trig.offset,
                                          name, trig.velocity))
        for strip, velocity in self._pending_triggers:
            name = self._strip_name(strip)
            e._trigger_queue.append((e._names[name], velocity, 0))
        self._pending_triggers.clear()

        action = self.performance.update_clock(beat, running)
        self.performance.applying_playback = True
        if action is not None:
            if action[0] == "trigger":
                ev_ = action[1]
                self._apply_chord(ev_.root, ev_.scale_type, ev_.degree,
                                  ev_.voicing, ev_.preset, ev_.octave,
                                  ev_.velocity)
            else:
                self._release_chord()
        for hit in self.performance.take_sampler_hits():
            self.sampler_trigger(hit.rack, hit.slot, hit.velocity,
                                 from_playback=True)
        self.performance.applying_playback = False

        self._stage_strip_gating()

        ev = e._collect_events()

        # stage snapshot: targets + snap masks (Engine._stage_kind, staged)
        stage_tgt, stage_snap = {}, {}
        for kind in e.instrument_kinds():
            stage_tgt[kind] = np.stack(e._targets[kind]).astype(np.float32)
            mask = np.zeros(len(e._targets[kind]), bool)
            for k2, s2 in e._snap_queue:
                if k2 == kind:
                    mask[s2] = True
            stage_snap[kind] = mask
        e._snap_queue.clear()
        for kind in e.instrument_kinds():
            e._dirty[kind] = False
        pan_tgt = np.asarray(e._pan, np.float32).copy()
        gain_tgt = np.asarray(e._gain, np.float32).copy()
        e._mix_dirty = False

        gran_ev = self.gran_host.collect_events(self.sample_count, B,
                                                device=False)
        rack_evs = []
        for rack in self.racks:
            if rack is not None:
                rack_evs.append(rack.collect_events(self.sample_count, B,
                                                    device=False))

        # per-step note overrides restore AFTER this block's trigger latched
        # (per-block path: set_param + snap after the dispatch → next stage)
        for name, pname, saved in self._post_restore:
            e.set_param(name, pname, saved)
            e._snap_queue.append(e._names[name])
        self._post_restore = []

        e.sample_count += B
        self.sample_count += B
        return dict(ev=ev, stage_tgt=stage_tgt, stage_snap=stage_snap,
                    pan_tgt=pan_tgt, gain_tgt=gain_tgt, gran=gran_ev,
                    racks=tuple(rack_evs))

    def _render_span(self, K: int):
        """Render K blocks via ONE scanned dispatch → ``[2, K*B]``."""
        B = self.block
        e = self.engine

        for i, rack in enumerate(self.racks):
            if rack is not None and rack.arena_dirty:
                self.rack_states[i] = self.rack_states[i]._replace(
                    arena=jnp.asarray(rack.arena))
                rack.arena_dirty = False

        # 1. loop mixer: its own batched scan (mixer.render_blocks), which
        # also yields the per-block transport beats the planner needs
        beats = []
        loop_out = self.mixer.render_blocks(K, collect_beats=beats)
        loop_seq = loop_out.reshape(2, K, B).transpose(1, 0, 2)   # [K, 2, B]

        # 2. host planning: K blocks of events with eager staging disabled
        if self._source_matrix is None:
            self._source_matrix = self._build_source_matrix()
        if self._strip_voice_idx is None:
            self._strip_voice_idx = np.asarray(
                [e._global_voice_index(self._strip_name(s))
                 for s in range(NUM_KIT_CHANNELS + 1)], np.int32)
        # gate strips BEFORE the state build/flush: on the very first render
        # `_stage` runs `_build_state`, whose pan/gain banks must start from
        # the gated values exactly like the per-block path (which gates
        # before its first `_stage`) — else block 0 ramps from defaults
        self._stage_strip_gating()
        e._stage()                      # flush pending host writes first
        carry_engine = dict(e._state)
        e._state = None
        try:
            plans = [self._plan_host_block(beat, running)
                     for beat, running in beats]
        finally:
            e._state = carry_engine

        # 3. normalize ragged trigger shapes (a multi-trigger block widens
        # every block of that kind to [V, Kmax]; rare, correct, slower)
        kinds = e.instrument_kinds()
        for kind in kinds:
            offs = [p["ev"][kind + "_off"] for p in plans]
            km = max(o.shape[1] if o.ndim == 2 else 1 for o in offs)
            if km == 1 and all(o.ndim == 1 for o in offs):
                continue
            for p in plans:
                evd = p["ev"]
                for suffix, fill in (("_off", B), ("_vel", 0.0)):
                    a = evd[kind + suffix]
                    a2 = a[:, None] if a.ndim == 1 else a
                    pad = np.full((a2.shape[0], km - a2.shape[1]), fill,
                                  a2.dtype)
                    evd[kind + suffix] = np.concatenate([a2, pad], axis=1)
                fkey = {"poly": "poly_freq", "bass": "bass_freq"}.get(kind)
                if fkey is not None:
                    a = evd[fkey]
                    a2 = a[:, None] if a.ndim == 1 else a
                    pad = np.zeros((a2.shape[0], km - a2.shape[1]), a2.dtype)
                    evd[fkey] = np.concatenate([a2, pad], axis=1)

        # 4. stack the per-block plans into scan inputs
        import jax.tree_util as jtu

        xs = jtu.tree_map(lambda *ls: np.stack(ls), *plans)
        xs["loop_out"] = loop_seq

        enabled_entries = [
            (i, ent) for i, ent in enumerate(self.fx.entries)
            if self.fx_enabled.get(ent.effect_id, False)
        ]
        fx_key = tuple((ent.effect_id, _fx_flag(ent))
                       for _, ent in enabled_entries)
        sc_voice = -1
        if self.sidechain_strip is not None and any(
            ent.effect_id == chain_mod.EFFECT_COMPRESSOR
            for _, ent in enabled_entries
        ):
            sc_voice = int(e._global_voice_index(
                self._strip_name(self.sidechain_strip)))

        g = self.graph
        if g._smooth is None:
            g._smooth = SmootherBank.init(g._strip_targets())
        if g._routing_dev is None:
            g._routing_dev = jnp.asarray(g.routing_matrix())
        if g._targets_host is None:
            g._targets_host = jnp.asarray(g._strip_targets())
        rack_slots = tuple(i for i, r in enumerate(self.racks)
                           if r is not None)

        carry = dict(
            engine=carry_engine,
            gran=self.gran_state,
            racks=tuple(self.rack_states[i] for i in rack_slots),
            fx=tuple(self.fx.states[i] for i, _ in enabled_entries),
            master=self.master,
            gbank=g._smooth,
            gracks=tuple(tuple(t.rack.states) for t in g.tracks),
            strip_peak=self._strip_peak_dev,
            graph_peak=jnp.zeros(len(g.tracks), jnp.float32),
        )
        consts = dict(
            source_matrix=jnp.asarray(self._source_matrix),
            graph_targets=g._targets_host,
            graph_routing=g._routing_dev,
            graph_rack_targets=tuple(tuple(t.rack.targets_list())
                                     for t in g.tracks),
            fx_targets=tuple(np.asarray(ent.targets)
                             for _, ent in enabled_entries),
            limiter_threshold=jnp.float32(self.limiter_threshold),
            strip_idx=jnp.asarray(self._strip_voice_idx),
        )
        carry2, bus_seq = _span_render(
            carry, consts, xs,
            kinds=kinds, sample_rate=self.sr, block_size=B,
            smooth_coeff=self._smooth_coeff, family_static=e._static_key(),
            lfo_routes=e._routes_static(), fx_key=fx_key,
            limiter_enabled=bool(self.limiter_enabled),
            rack_slots=rack_slots,
            graph_rack_keys=tuple(t.rack.static_key() for t in g.tracks),
            graph_coeff=g._coeff, sidechain_voice=sc_voice,
        )

        # 5. land the final carry back in the host objects
        e._state = dict(carry2["engine"])
        self.gran_state = carry2["gran"]
        for i, slot in enumerate(rack_slots):
            self.rack_states[slot] = carry2["racks"][i]
        for (i, _), st in zip(enabled_entries, carry2["fx"]):
            self.fx.states[i] = st
        self.master = carry2["master"]
        g._smooth = carry2["gbank"]
        for t, st in zip(g.tracks, carry2["gracks"]):
            t.rack.states = list(st)
        self._strip_peak_dev = carry2["strip_peak"]
        g.record_peaks(carry2["graph_peak"])

        return bus_seq.transpose(1, 0, 2).reshape(2, -1)    # [2, K*B]

    def _render_one_block(self):
        B = self.block
        e = self.engine

        # 2. sampler rack transport-due activation (ffi.rs:1143-1150)
        beat = self.mixer.clip_grid.transport_beat
        for rack in self.racks:
            if rack:
                rack.activate_start_if_due(beat)

        # 3+4. strip sequencers → engine triggers with blend/note handling
        for strip, seq in enumerate(self.sequencers):
            name = self._strip_name(strip)
            kind, slot = e._names[name]
            for trig in seq.tick_block(B):
                if trig.blend is not None and self.blenders[strip] is not None:
                    cfg = self.blenders[strip].blend(*trig.blend)
                    # queue the snap BEFORE the setter: set_config eager-
                    # stages (and consumes pending snaps for the kind), so
                    # the reversed order starved the snap until the next
                    # dirty event — the reference snaps at the trigger
                    # (ffi.rs:1163-1205 snap_params)
                    e._snap_queue.append((kind, slot))
                    e.set_config(name, cfg)
                if trig.note is not None and kind != "bass":
                    # per-step MIDI note → param-0 override (save/restore):
                    # the trigger latches the note-derived frequency
                    mod = FAMILIES[kind]
                    pname = mod.PARAM_NAMES[0]
                    saved = e.get_param(name, pname)
                    freq = music.midi_to_freq(trig.note)
                    lo, hi = getattr(mod, "FREQ_RANGE", (30.0, 120.0))
                    e._snap_queue.append((kind, slot))  # before the setter (see blend)
                    e.set_param(name, pname, float(np.clip((freq - lo) / (hi - lo), 0, 1)))
                    e._trigger_queue.append(((kind, slot), trig.velocity,
                                             trig.offset))
                    # two note steps for the same strip in one block: keep
                    # the FIRST saved value (the second read would see the
                    # first note's override, not the user's param)
                    if not any(n == name and p == pname
                               for n, p, _ in self._post_restore):
                        self._post_restore.append((name, pname, saved))
                else:
                    e._trigger_queue.append(((kind, slot), trig.velocity,
                                             trig.offset))
                if len(self.midi_out) < 64:  # overflow drops new (ffi.rs:69-71)
                    self.midi_out.append((self.sample_count + trig.offset,
                                          name, trig.velocity))
        for strip, velocity in self._pending_triggers:
            name = self._strip_name(strip)
            # manual triggers land at block start (ffi.rs:1078-1095 drain)
            e._trigger_queue.append((e._names[name], velocity, 0))
        self._pending_triggers.clear()

        # 5. performance clip replay (ffi.rs:1212-1235)
        action = self.performance.update_clock(
            beat, self.mixer.clip_grid.transport_running
        )
        self.performance.applying_playback = True
        if action is not None:
            if action[0] == "trigger":
                ev = action[1]
                self._apply_chord(ev.root, ev.scale_type, ev.degree, ev.voicing,
                                  ev.preset, ev.octave, ev.velocity)
            else:
                self._release_chord()
        for hit in self.performance.take_sampler_hits():
            self.sampler_trigger(hit.rack, hit.slot, hit.velocity, from_playback=True)
        self.performance.applying_playback = False

        # 6+7. instrument banks → panned source frames (LFO routes inside)
        if self._source_matrix is None:
            self._source_matrix = self._build_source_matrix()
        self._stage_strip_gating()

        e._stage()
        events = e._collect_events()
        e._stage()
        events["source_matrix"] = jnp.asarray(self._source_matrix)
        new_state, sources, all_voices, voice_peaks = eng._render_all_jit(
            e._state, events,
            kinds=e.instrument_kinds(), sample_rate=self.sr, block_size=B,
            smooth_coeff=e.smooth_coeff, limiter_threshold=1.0,
            family_static=e._static_key(), lfo_routes=e._routes_static(),
            fx_order=(), sidechain_voice=-1, collect_sources=True,
        )
        e._state = new_state
        e.sample_count += B

        # restore per-step note overrides after the triggers latched them
        # (one entry per note-bearing step — several strips may carry notes
        # in the same block, each must get its frequency param back)
        for name, pname, saved in self._post_restore:
            e._snap_queue.append(e._names[name])  # before the setter (see blend)
            e.set_param(name, pname, saved)
        self._post_restore = []

        # strip peaks: fold into the device accumulator — NO host sync here
        # (ffi.rs:649-658 peak metering; drained by take_strip_peak)
        if self._strip_voice_idx is None:
            self._strip_voice_idx = np.asarray(
                [e._global_voice_index(self._strip_name(s))
                 for s in range(NUM_KIT_CHANNELS + 1)], np.int32)
        self._strip_peak_dev = jnp.maximum(
            self._strip_peak_dev, voice_peaks[self._strip_voice_idx]
        )

        # granulator (center-panned mono source)
        gev = self.gran_host.collect_events(self.sample_count, B)
        self.gran_state, gout = self._gran_render(
            self.gran_state, gev, np.int32(self.sample_count)
        )
        sqrt_half = np.float32(np.sqrt(0.5))
        gran_frame = jnp.stack([gout * sqrt_half, gout * sqrt_half])
        sources = sources.at[graph_mod.SOURCE_GRANULATOR].set(gran_frame)

        # loop mixer
        loop_out = self.mixer.render_block()
        sources = sources.at[graph_mod.SOURCE_LOOPMIXER].set(loop_out)

        # sampler racks
        for i, rack in enumerate(self.racks):
            if rack is None:
                continue
            sev = rack.collect_events(self.sample_count, B)
            if rack.arena_dirty:
                self.rack_states[i] = self.rack_states[i]._replace(
                    arena=jnp.asarray(rack.arena)
                )
                rack.arena_dirty = False
            self.rack_states[i], rout = self._rack_render(
                self.rack_states[i], sev, np.int32(self.sample_count)
            )
            sources = sources.at[graph_mod.SOURCE_SAMPLER_BASE + i].set(rout)

        # 8. mixer graph
        master_bus, track_peaks = self.graph.render(sources, B)
        self.graph.record_peaks(track_peaks)

        # 9. master gain → global FX chain (enabled, user order) → limiter
        from libgooey_tpu.core.smoother import smooth_block

        self.master, mtraj = smooth_block(self.master, self._smooth_coeff, B)
        bus = master_bus * mtraj[None, :]
        enabled_entries = [
            (i, ent) for i, ent in enumerate(self.fx.entries)
            if self.fx_enabled.get(ent.effect_id, False)
        ]
        sidechain = None
        if self.sidechain_strip is not None and any(
            ent.effect_id == chain_mod.EFFECT_COMPRESSOR
            for _, ent in enabled_entries
        ):
            # per-instrument external sidechain (compressor.rs:230-247):
            # the detector tracks the chosen strip's dry voice signal
            idx = e._global_voice_index(self._strip_name(self.sidechain_strip))
            sc = all_voices[idx]
            sidechain = jnp.stack([sc, sc], axis=0)
        key = tuple((ent.effect_id, _fx_flag(ent)) for _, ent in enabled_entries)
        targets = tuple(jnp.asarray(ent.targets) for _, ent in enabled_entries)
        states = tuple(self.fx.states[i] for i, _ in enabled_entries)
        new_states, bus = _fx_chain_jit(
            states, bus, targets, key, sidechain,
            jnp.float32(self.limiter_threshold),
            sample_rate=self.sr,
            limiter_enabled=bool(self.limiter_enabled),
        )
        for (i, _), st in zip(enabled_entries, new_states):
            self.fx.states[i] = st

        self.sample_count += B
        return bus

    # --- misc API ------------------------------------------------------------------------------------

    def set_master_gain(self, gain: float):
        self.master = self.master.with_targets(np.float32(gain))

    def take_strip_peak(self, strip: int) -> float:
        # drain the device accumulator into the host mirror (the only sync
        # point for peaks — a host-initiated query, off the render hot path)
        dev = np.asarray(self._strip_peak_dev)
        if dev.any():
            np.maximum(self.strip_peak, dev, out=self.strip_peak)
            self._strip_peak_dev = jnp.zeros_like(self._strip_peak_dev)
        p = float(self.strip_peak[strip])
        self.strip_peak[strip] = 0.0
        return p

    def drain_midi_out(self):
        out = self.midi_out
        self.midi_out = []
        return out

    def bounce_to_buffer(self, frames: int) -> np.ndarray:
        """Offline render (interleaved), like gooey_engine_bounce_to_buffer."""
        return self.render(frames)

    def bounce_to_wav(self, path, frames: int, bits: int = 16):
        from libgooey_tpu.io_wav import write_wav

        inter = self.render(frames)
        write_wav(path, inter.reshape(-1, 2).T, int(self.sr), bits=bits)
        return inter
