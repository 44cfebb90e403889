"""Tom2: the Max-derived FFI tom (morph oscillator + membrane resonator).

Behavioral reference: src/instruments/tom2.rs (594 LoC).  Signal path
(tom2.rs:427-594):

* MaxCurve envelope [(1, 1 ms, 0.8), (0, decay, -0.83)], decay latched at
  trigger from the 0-100 `decay` knob (0.5-4000 ms);
* pitch = ``tune_freq * (1 + (env * bend_scaled)^2)`` where
  ``tune_freq = 40 + (tune/100)^2 * 560`` and ``bend_scaled = bend/50``;
* sources: ClickOsc impulse * 1.1 + standalone triangle * 0.5 + MorphOsc
  (mix control from `tone`, rand~ rate from `color` via a double-mtof);
* RBJ constant-gain bandpass tracking the pitch (q = 1 + (color/100)^2,
  gain 1.1), then the VCA envelope;
* MembraneResonator wet path rings past the VCA (`main_sound_done`), with a
  ring-level fade; sub-40 Hz fade-out guard; output gain 0.7 * volume/100.

Tom2 parameters are plain values (0-100, Max convention) — the reference
does not smooth them — and velocity is ignored by its trigger.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional

import jax.numpy as jnp
import numpy as np

from libgooey_tpu.core import dsp
from libgooey_tpu.core.max_curve import max_curve
from libgooey_tpu.instruments.common import NEVER
from libgooey_tpu.ops import filters, morph
from libgooey_tpu.ops import scan as gscan

PARAM_NAMES = (
    "tune", "bend", "tone", "color", "decay", "membrane", "membrane_q", "volume",
    "tuning",
)
NUM_PARAMS = len(PARAM_NAMES)
PARAM_INDEX = {n: i for i, n in enumerate(PARAM_NAMES)}

FREQ_MIN, FREQ_MAX = 40.0, 600.0
FADE_START_FREQ, MIN_AUDIBLE_FREQ = 40.0, 20.0
DECAY_MIN_MS, DECAY_MAX_MS = 0.5, 4000.0


@dataclass(frozen=True)
class Tom2Config:
    """0-100 ranged params (Max convention), tuning 0-1 (tom2.rs:105-178)."""

    tune: float = 60.0
    bend: float = 70.0
    tone: float = 50.0
    color: float = 0.0
    decay: float = 20.0
    membrane: float = 0.0
    membrane_q: float = 50.0
    volume: float = 100.0
    tuning: float = 0.5

    def as_array(self) -> np.ndarray:
        return np.array([getattr(self, n) for n in PARAM_NAMES], np.float32)

    @staticmethod
    def derp():
        return Tom2Config()

    @staticmethod
    def ring():
        return Tom2Config(80.0, 20.0, 10.0, 0.0, 100.0, 60.0, 70.0, 100.0)

    @staticmethod
    def brush():
        return Tom2Config(40.0, 20.0, 10.0, 90.0, 30.0, 0.0, 50.0, 100.0)

    @staticmethod
    def void_preset():
        return Tom2Config(60.0, 30.0, 100.0, 50.0, 90.0, 40.0, 80.0, 100.0)


PRESETS = {
    "default": Tom2Config.derp,
    "derp": Tom2Config.derp,
    "ring": Tom2Config.ring,
    "brush": Tom2Config.brush,
    "void": Tom2Config.void_preset,
}


def tune_to_freq(tune):
    """tune 0-100 → 40-600 Hz with a pow-2 knee (tom2.rs:243-249)."""
    n = tune / 100.0
    return FREQ_MIN + n * n * (FREQ_MAX - FREQ_MIN)


class Tom2State(NamedTuple):
    params: jnp.ndarray          # [V, NUM_PARAMS] — plain, unsmoothed
    trig_sample: jnp.ndarray     # [V] i32
    decay_s: jnp.ndarray         # [V] latched decay seconds
    tri_phase: jnp.ndarray       # [V]
    morph: morph.MorphState      # [V] fields
    bandpass: filters.BiquadState
    membrane: filters.MembraneState


def init_state(num_voices: int, config: Optional[Tom2Config] = None, targets=None) -> Tom2State:
    if targets is None:
        targets = np.broadcast_to(
            (config or Tom2Config()).as_array(), (num_voices, NUM_PARAMS)
        )
    v = (num_voices,)
    return Tom2State(
        params=jnp.asarray(targets, jnp.float32),
        trig_sample=jnp.full(v, NEVER, jnp.int32),
        decay_s=jnp.full(v, 2.0, jnp.float32),
        tri_phase=jnp.zeros(v, jnp.float32),
        morph=morph.MorphState.init(v),
        bandpass=filters.BiquadState.init(v),
        membrane=filters.MembraneState.init(v),
    )


def render_block(
    state: Tom2State,
    trig_offset,
    trig_velocity,  # ignored (tom2.rs trigger discards velocity)
    block_start,
    *,
    sample_rate: float,
    block_size: int,
    smooth_coeff: float = 0.0,  # unused; uniform instrument signature
    triangle_enabled: bool = True,
    overrides=None,  # Tom2 is not Modulatable in the reference; accepted+ignored
):
    """Render one block for the Tom2 bank → ``(new_state, out[V, B])``."""
    del trig_velocity, smooth_coeff
    sr = sample_rate
    B = block_size

    n_local = jnp.arange(B, dtype=jnp.int32)
    trig_offset = jnp.asarray(trig_offset, jnp.int32)
    block_start = jnp.asarray(block_start, jnp.int32)
    if trig_offset.ndim == 1:
        trig_offset = trig_offset[:, None]   # [V, K] trigger slots (ascending)
    valid_k = trig_offset < B                                          # [V, K]
    has_trig = jnp.any(valid_k, axis=1)
    after_k = (n_local[None, None, :] >= trig_offset[:, :, None]) & valid_k[:, :, None]
    after = jnp.any(after_k, axis=1)
    at_trig = jnp.any(
        (n_local[None, None, :] == trig_offset[:, :, None]) & valid_k[:, :, None],
        axis=1,
    )
    trig_global = block_start + trig_offset                             # [V, K]
    trig_eff = jnp.broadcast_to(state.trig_sample[:, None], after.shape)
    for _k in range(trig_offset.shape[1]):
        trig_eff = jnp.where(after_k[:, _k, :], trig_global[:, _k, None], trig_eff)
    n_global = block_start + n_local
    elapsed_i = n_global[None, :] - trig_eff
    elapsed = elapsed_i.astype(jnp.float32) * np.float32(1.0 / sr)

    p = lambda name: state.params[:, PARAM_INDEX[name]][:, None]  # [V,1]

    decay_new = (DECAY_MIN_MS + (state.params[:, PARAM_INDEX["decay"]] / 100.0)
                 * (DECAY_MAX_MS - DECAY_MIN_MS)) * 0.001
    decay_s = jnp.where(after, decay_new[:, None], state.decay_s[:, None])

    # --- envelope: [(1, 1ms, 0.8), (0, decay, -0.83)] ---------------------
    attack_s = 0.001
    in_attack = elapsed < attack_s
    env = jnp.where(
        in_attack,
        max_curve(elapsed / attack_s, 0.8),
        1.0 - max_curve(jnp.clip((elapsed - attack_s) / decay_s, 0.0, 1.0), -0.83),
    )
    env = jnp.where(elapsed < 0.0, 0.0, env)
    env_complete = elapsed >= (attack_s + decay_s)

    # --- pitch --------------------------------------------------------------
    base_freq = tune_to_freq(p("tune")) * dsp.tuning_to_multiplier(p("tuning"))
    bend_scaled = (p("bend") / 100.0) * 2.0
    pitch_mod = jnp.square(env * bend_scaled)
    raw_freq = base_freq * (1.0 + pitch_mod)

    past_attack = (elapsed >= attack_s) | (env > 0.9)
    main_done = env_complete | (past_attack & (raw_freq < MIN_AUDIBLE_FREQ))
    fade_factor = jnp.where(
        past_attack & (raw_freq < FADE_START_FREQ),
        (raw_freq - MIN_AUDIBLE_FREQ) / (FADE_START_FREQ - MIN_AUDIBLE_FREQ),
        1.0,
    )
    modulated_freq = jnp.maximum(raw_freq, FREQ_MIN)

    # --- sources ------------------------------------------------------------
    click_out = morph.click_block(elapsed_i) * 1.1

    tri_inc = modulated_freq / sr
    tri_phase = gscan.phase_cumsum_reset(tri_inc, at_trig, state.tri_phase)
    tri_out = (
        morph.triangle_from_phase(jnp.mod(tri_phase - tri_inc, 1.0)) * 0.5
        if triangle_enabled
        else jnp.zeros_like(click_out)
    )

    mix_control = (p("tone") / 100.0) * 2.0 - 1.0
    color_midi = 30.0 + (p("color") / 100.0) * 20.0
    color_freq_1 = morph.mtof(color_midi)
    morph_state, morph_out = morph.morph_block(
        state.morph, modulated_freq, mix_control + jnp.zeros_like(env),
        color_freq_1 + jnp.zeros_like(env), p("tone") + jnp.zeros_like(env),
        elapsed_i, at_trig, sr,
    )

    mixed = click_out + tri_out + morph_out

    last_trig = state.trig_sample
    for _k in range(trig_offset.shape[1]):
        last_trig = jnp.where(valid_k[:, _k], trig_global[:, _k], last_trig)
    new_trig = last_trig
    new_decay = jnp.where(has_trig, decay_new, state.decay_s)
    new_tri_phase = jnp.mod(tri_phase[:, -1], 1.0)

    bp_state, mem_state, out = _back_half(
        state, at_trig, elapsed_i, mixed, env, main_done, fade_factor,
        modulated_freq, sr)

    new_state = Tom2State(
        params=state.params,
        trig_sample=new_trig,
        decay_s=new_decay,
        tri_phase=new_tri_phase,
        morph=morph_state,
        bandpass=bp_state,
        membrane=mem_state,
    )
    return new_state, out


def _back_half(state, at_trig, elapsed_i, mixed, env, main_done, fade_factor,
               modulated_freq, sr):
    """Bandpass + membrane recurrences and output composition."""
    p = lambda name: state.params[:, PARAM_INDEX[name]][:, None]  # [V,1]

    # --- pitch-tracking bandpass (q = 1 + (color/100)^2, gain 1.1) -------------
    filter_freq = jnp.maximum(modulated_freq, 20.0)
    color_n = p("color") / 100.0
    coeffs = filters.rbj_bandpass_coeffs(filter_freq, 1.0 + color_n * color_n, 1.1, sr)
    bp_state, filtered = filters.biquad_df1_block(state.bandpass, mixed, coeffs, reset=at_trig)

    # --- membrane resonator -------------------------------------------------------
    q_scale = 0.005 + (state.params[:, PARAM_INDEX["membrane_q"]] / 100.0) * 0.015
    gain_scale = jnp.full_like(q_scale, 0.003)  # tom input gain (tom2.rs:393-398)
    membrane_mix = p("membrane") / 100.0
    membrane_input = jnp.where(main_done, 0.0, filtered * env)
    membrane_input = jnp.where(membrane_mix > 0.0, membrane_input, jnp.zeros_like(membrane_input))
    mem_state, mem_out, ring = filters.membrane_block(
        state.membrane, membrane_input, q_scale, gain_scale, sr, reset=at_trig
    )
    mem_out = jnp.where(membrane_mix > 0.0, mem_out, 0.0)
    fade = filters.membrane_fade(ring)

    vol = p("volume") / 100.0
    dry = filtered * env
    mixed_out = dry * (1.0 - membrane_mix) + mem_out * membrane_mix
    ring_only = mem_out * membrane_mix * fade * 0.7 * vol
    normal = mixed_out * fade_factor * 0.7 * vol
    out = jnp.where(main_done, ring_only, normal)
    # fully inactive: main done and membrane not ringing (tom2.rs:478-482)
    out = jnp.where(main_done & (ring <= 0.0001), 0.0, out)
    out = jnp.where(elapsed_i >= 0, out, 0.0)
    return bp_state, mem_state, out
