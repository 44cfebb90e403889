"""MorphOsc and ClickOsc: the Max-derived tom sources, blocked.

Behavioral reference: src/gen/morph_osc.rs and src/gen/click_osc.rs.

MorphOsc — a 3-channel crossfade (``mix3``) of:
  1. ring mod: sine(phase@f)*0.5 * sine(phase@190Hz)*0.5
  2. triangle(phase@f)*0.5 + combined noise
  3. combined noise + gated sine*0.2 (gate open when tone < 99)
combined noise = (white*0.2 + rand~)*0.4 where rand~ ramps linearly between
random values at ``mtof(color_freq)`` rate.

Block mapping: the phase accumulators become per-block cumulative sums with
carried state and trigger resets; the rand~ sample-and-hold becomes a pure
function of the accumulated rand phase (segment index -> hashed target),
which deviates from the reference only in *which* random value each segment
gets (ours hashes the segment count; the reference hashes the sample counter
at the wrap — same statistics, different bits).
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
import numpy as np

from libgooey_tpu.core import rng
from libgooey_tpu.ops import scan as gscan

TWO_PI = float(2.0 * np.pi)
RAND_SEED = 0x12345678


def mtof(midi):
    """MIDI note → frequency (morph_osc.rs:36-38)."""
    return 440.0 * jnp.exp2((midi - 69.0) / 12.0)


def triangle_from_phase(phase):
    """Naive /\\ triangle from phase in [0,1) (morph_osc.rs:24-32)."""
    t = jnp.mod(phase, 1.0)
    return jnp.where(t < 0.5, 4.0 * t - 1.0, 3.0 - 4.0 * t)


class MorphState(NamedTuple):
    """Carried phases, ``[V]`` each."""

    main_phase: jnp.ndarray
    tri_phase: jnp.ndarray
    fixed_phase: jnp.ndarray
    gated_phase: jnp.ndarray
    #: rand~ position carried as (segment count, fractional phase) so f32
    #: precision does not decay over long notes — at high `color` the rand
    #: rate is ~15 kHz (the Max patch's double-mtof) and an unwrapped
    #: accumulator would exceed f32's integer-exact range within seconds
    rand_seg: jnp.ndarray    # i32 segments since trigger
    rand_frac: jnp.ndarray   # f32 in [0, 1)

    @staticmethod
    def init(shape=()) -> "MorphState":
        z = jnp.zeros(shape, jnp.float32)
        return MorphState(z, z, z, z, jnp.zeros(shape, jnp.int32), z)


def morph_block(
    state: MorphState,
    frequency,      # [V, B] per-sample oscillator frequency
    mix_control,    # [V, B] crossfade control (-1..1)
    color_freq,     # [V, B] first-mtof result (~46-147 Hz)
    tone,           # [V, B] 0-100, gates the channel-3 sine
    elapsed_i,      # [V, B] int samples since trigger (noise counter)
    reset,          # [V, B] trigger reset mask
    sample_rate: float,
):
    """One block of the morph oscillator → ``(new_state, out[V, B])``."""
    sr = sample_rate

    def accum(inc, carry):
        """Unwrapped cumsum with trigger resets, split-increment form.

        The rand~ accumulator reaches ~inc*B per block (tens of cycles at
        high `color`), so a plain tree cumsum rounds at eps(total) per
        combine level — enough to flip floor(total) segment boundaries
        against the sequential oracle.  Split the block-start increment
        ``inc0 = hi + lo`` with ``hi`` on a 2^-11 grid: ``hi*(n+1)`` is
        exact (total*2048 < 2^24 grid steps), ``lo*(n+1)`` and the
        residual cumsum of ``inc - inc0`` (zero for tom2's block-constant
        rate) carry one rounding each.  The reset base-latch scan has
        coefficients in {0, 1}, so it is exact under any scan order.
        """
        B = inc.shape[-1]
        n1 = jnp.arange(1, B + 1, dtype=jnp.float32)
        reset_f = jnp.asarray(reset, jnp.float32)
        inc0 = inc[..., 0:1]
        hi = jnp.floor(inc0 * 2048.0) / 2048.0
        lo = inc0 - hi
        ramp = hi * n1 + lo * n1
        resid = jnp.cumsum(inc - inc0, axis=-1)
        p = ramp + resid
        p_prev = jnp.concatenate(
            [jnp.zeros_like(p[..., 0:1]), p[..., :-1]], axis=-1)
        base = gscan.linrec1(
            1.0 - reset_f, reset_f * p_prev, -jnp.asarray(carry, jnp.float32))
        return p - base

    inc = frequency / sr
    # exact mod-1 accumulation (~1e-7 cycles/block; see
    # scan.phase_cumsum_reset) — the rand~ accumulator below stays a raw
    # cumsum because it needs the unwrapped total for segment counting
    main_phase = gscan.phase_cumsum_reset(inc, reset, state.main_phase)
    tri_phase = gscan.phase_cumsum_reset(inc, reset, state.tri_phase)
    gated_phase = gscan.phase_cumsum_reset(inc, reset, state.gated_phase)
    fixed_phase = gscan.phase_cumsum_reset(
        jnp.full_like(inc, 190.0 / sr), reset, state.fixed_phase
    )

    # NOTE (phase semantics): the reference *uses* the phase, then advances —
    # so at the first sample after reset the phase is 0.  Our cumulative sum
    # gives the advanced value; shift by one increment.
    def used(phase, inc):
        return jnp.mod(phase - inc, 1.0)

    main_sine = jnp.sin(TWO_PI * used(main_phase, inc)) * 0.5
    tri = triangle_from_phase(used(tri_phase, inc)) * 0.5
    fixed_sine = jnp.sin(TWO_PI * used(fixed_phase, 190.0 / sr)) * 0.5
    gated_sine = jnp.where(
        tone < 99.0, jnp.sin(TWO_PI * used(gated_phase, inc)) * 0.2, 0.0
    )

    # white noise: hash of samples-since-trigger (counter resets at trigger)
    white = rng.white(jnp.asarray(elapsed_i, jnp.int32).astype(jnp.uint32)) * 0.2

    # rand~ sample-and-hold with linear ramps at mtof(color_freq) Hz.
    # Accumulate only the within-block total on top of the carried frac
    # (bounded ≤ ~1 + B·inc, so f32 keeps full fractional precision) and
    # rebase the carried segment count as an integer.
    rand_freq = mtof(color_freq)
    total = accum(rand_freq / sr, state.rand_frac)
    seg_local = jnp.floor(total)
    frac = total - seg_local
    # the carried segment base resets to 0 from the trigger sample on
    after = jnp.cumsum(jnp.asarray(reset, jnp.int32), axis=-1) > 0
    seg_base = jnp.where(after, 0, state.rand_seg[..., None])
    seg = seg_base + seg_local.astype(jnp.int32)
    # segment 0 ramps from 0 to 0 (reference starts with current=target=0)
    tgt = jnp.where(seg >= 1, rng.white(seg.astype(jnp.uint32), RAND_SEED), 0.0)
    cur = jnp.where(seg >= 2, rng.white((seg - 1).astype(jnp.uint32), RAND_SEED), 0.0)
    rand_value = cur + (tgt - cur) * frac

    noise_combined = (white + rand_value) * 0.4

    ch1 = main_sine * fixed_sine
    ch2 = tri + noise_combined
    ch3 = noise_combined + gated_sine

    w1 = jnp.clip(-mix_control, 0.0, 1.0)
    w2 = jnp.clip(1.0 - jnp.abs(mix_control), 0.0, 1.0)
    w3 = jnp.clip(mix_control, 0.0, 1.0)
    out = ch1 * w1 + ch2 * w2 + ch3 * w3

    new_state = MorphState(
        main_phase=main_phase[..., -1],
        tri_phase=tri_phase[..., -1],
        fixed_phase=fixed_phase[..., -1],
        gated_phase=gated_phase[..., -1],
        rand_seg=seg[..., -1],
        rand_frac=frac[..., -1],
    )
    return new_state, out


# --- ClickOsc ------------------------------------------------------------------

#: The 64-sample tom attack impulse (waveform data from the reference's Max
#: patch `setimpulse` table, src/gen/click_osc.rs:7-14).
TOM_IMPULSE = np.array(
    [
        0.884058, 0.942029, 0.913043, 0.869565, 0.833333, 0.797101, 0.772947,
        0.748792, 0.724638, 0.695652, 0.666667, 0.637681, 0.619565, 0.601449,
        0.583333, 0.565217, 0.536232, 0.507246, 0.478261, 0.449275, 0.42029,
        0.391304, 0.371981, 0.352657, 0.333333, 0.304348, 0.275362, 0.23913,
        0.202899, 0.181159, 0.15942, 0.137681, 0.115942, 0.101449, 0.086957,
        0.072464, 0.057971, 0.043478, 0.028986, 0.014493, 0.009662, 0.004831,
        0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.014493,
        0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0,
    ],
    np.float32,
)


def click_block(elapsed_i):
    """One-shot 64-sample wavetable playback from the trigger sample.

    Pure function of samples-since-trigger (click_osc.rs:44-77).
    """
    idx = jnp.asarray(elapsed_i, jnp.int32)
    table = jnp.asarray(TOM_IMPULSE)
    in_range = (idx >= 0) & (idx < table.shape[0])
    return jnp.where(in_range, table[jnp.clip(idx, 0, table.shape[0] - 1)], 0.0)
