"""Recursive filters as blocked linear recurrences over ``[V, B]``.

Each filter follows the same pattern: compute per-sample coefficient
trajectories from (smoothed, possibly modulated) parameters — vectorized —
then run the state recursion through ops.scan (first order: associative
scan; second order: sample-sequential, ``linrec2``).
State is carried across blocks in small per-voice arrays.

Behavioral references:
  * TPT/ZDF state-variable filter — src/filters/state_variable_tpt.rs and
    src/filters/resonant_lowpass.rs (Simper SVF: g = tan(pi*fc/sr), r = 1/Q,
    h = 1/(1 + r*g + g*g), states ic1eq/ic2eq).
  * Chamberlin SVF — src/filters/state_variable.rs (f = 2 sin(pi fc/sr),
    internally 2x-iterated for stability, LP/BP/HP/notch taps).
  * RBJ biquads — src/filters/biquad_bandpass.rs / biquad_highpass.rs
    (Direct Form I).
  * one-pole HP approximation — src/filters/resonant_highpass.rs.
  * DC blocker — src/effects/feedback_waveshaper.rs:262-271.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
import numpy as np

from libgooey_tpu.ops import scan as gscan

PI = float(np.pi)

def _shift1(x, x0):
    """Delay by one along the trailing axis with carried first value."""
    return jnp.concatenate([jnp.expand_dims(x0, -1), x[..., :-1]], axis=-1)


# --- TPT (Simper) state-variable filter -------------------------------------


class SVFState(NamedTuple):
    """TPT SVF integrator state (ic1eq, ic2eq), slice-shaped each."""

    ic1: jnp.ndarray
    ic2: jnp.ndarray

    @staticmethod
    def init(shape=()) -> "SVFState":
        z = jnp.zeros(shape, jnp.float32)
        return SVFState(ic1=z, ic2=z)


def svf_coeffs(cutoff_hz, q, sample_rate: float, min_hz=20.0, max_hz=20_000.0):
    """Per-sample (g, h) for the TPT SVF.  resonant_lowpass.rs:95-103."""
    cutoff = jnp.clip(cutoff_hz, min_hz, min(max_hz, sample_rate * 0.45))
    g = jnp.tan(PI * cutoff / sample_rate)
    r = 1.0 / jnp.clip(q, 0.5, 10.0)
    h = 1.0 / (1.0 + r * g + g * g)
    return g, h


def svf_tpt_block(state: SVFState, x, g, h, reset=None):
    """Run the TPT SVF over a block with (possibly per-sample) coefficients.

    Per-sample update (resonant_lowpass.rs:48-61):
        v1 = (g*(x - ic2) + ic1) * h
        v2 = ic2 + g*v1
        ic1' = 2*v1 - ic1 ; ic2' = 2*v2 - ic2

    In state-affine form s = (ic1, ic2):
        A = [[2h-1, -2hg], [2gh, 1-2g^2 h]],  b = [2hg, 2g^2 h] * x

    Returns ``(new_state, v1, v2)`` where v1/v2 are the per-sample band/low
    tap *pre-update* values (exactly the reference's outputs).
    ``reset`` zeroes the incoming state at masked samples (trigger resets).
    """
    g, h, x = jnp.broadcast_arrays(g, h, x)
    hg = h * g
    a11 = 2.0 * h - 1.0
    a12 = -2.0 * hg
    a21 = 2.0 * g * h
    a22 = 1.0 - 2.0 * g * g * h
    b1 = 2.0 * hg * x
    b2 = 2.0 * g * g * h * x
    if reset is not None:
        keep = jnp.where(reset, 0.0, 1.0)
        a11, a12, a21, a22 = a11 * keep, a12 * keep, a21 * keep, a22 * keep
    s1, s2 = gscan.linrec2(a11, a12, a21, a22, b1, b2, (state.ic1, state.ic2))
    ic1_prev = _shift1(s1, state.ic1)
    ic2_prev = _shift1(s2, state.ic2)
    if reset is not None:
        ic1_prev = jnp.where(reset, 0.0, ic1_prev)
        ic2_prev = jnp.where(reset, 0.0, ic2_prev)
    v1 = (g * (x - ic2_prev) + ic1_prev) * h
    v2 = ic2_prev + g * v1
    return SVFState(ic1=s1[..., -1], ic2=s2[..., -1]), v1, v2


def resonant_lowpass_block(state: SVFState, x, cutoff_hz, q, sample_rate, reset=None):
    """`ResonantLowpassFilter`: TPT SVF low-pass tap with denormal flush.

    resonant_lowpass.rs:48-61 (output = v2, flushed at 1e-15).
    """
    g, h = svf_coeffs(cutoff_hz, q, sample_rate)
    state, _v1, v2 = svf_tpt_block(state, x, g, h, reset=reset)
    out = jnp.where(jnp.abs(v2) < 1e-15, 0.0, v2)
    return state, out


def svf_tpt_outputs(state: SVFState, x, cutoff_hz, q, sample_rate, reset=None):
    """`StateVariableTPTFilter`: (lowpass, bandpass, highpass) taps.

    state_variable_tpt.rs:42-68: lp = v2, bp = v1, hp = x - r*v1 - v2.
    """
    cutoff = jnp.clip(cutoff_hz, 20.0, sample_rate * 0.45)
    g = jnp.tan(PI * cutoff / sample_rate)
    r = 1.0 / jnp.maximum(q, 0.5)  # only a lower clamp (state_variable_tpt.rs:44)
    h = 1.0 / (1.0 + r * g + g * g)
    state, v1, v2 = svf_tpt_block(state, x, g, h, reset=reset)
    lp = v2
    bp = v1
    hp = x - (r * v1 + v2)
    return state, lp, bp, hp


# --- one-pole structures -----------------------------------------------------


class OnePoleState(NamedTuple):
    y: jnp.ndarray

    @staticmethod
    def init(shape=()) -> "OnePoleState":
        return OnePoleState(y=jnp.zeros(shape, jnp.float32))


def onepole_lp_block(state: OnePoleState, x, coeff, reset=None):
    """``y += coeff * (x - y)`` over a block; returns (state, y traj)."""
    a = (1.0 - coeff) * jnp.ones_like(x)
    if reset is not None:
        a = jnp.where(reset, 0.0, a)
    y = gscan.linrec1(a, coeff * x, state.y)
    return OnePoleState(y=y[..., -1]), y


def resonant_highpass_block(state: OnePoleState, x, cutoff_hz, resonance, sample_rate, reset=None):
    """`ResonantHighpassFilter` — the intentionally cheap one-pole HP used for
    the kick click (resonant_highpass.rs:22-53).

        alpha = 1 - exp(-2pi*fc/sr); hp = x - state; state += alpha*hp
        out = hp * (1 + res*0.1)
    """
    alpha = 1.0 - jnp.exp(-2.0 * PI * cutoff_hz / sample_rate)
    state_new, y = onepole_lp_block(state, x, alpha, reset=reset)
    s_prev = _shift1(y, state.y)
    if reset is not None:
        s_prev = jnp.where(reset, 0.0, s_prev)
    hp = x - s_prev
    return state_new, hp * (1.0 + resonance * 0.1)


# --- DC blocker ---------------------------------------------------------------


class DCBlockState(NamedTuple):
    x1: jnp.ndarray
    y1: jnp.ndarray

    @staticmethod
    def init(shape=()) -> "DCBlockState":
        z = jnp.zeros(shape, jnp.float32)
        return DCBlockState(x1=z, y1=z)


def dc_block(state: DCBlockState, x, coeff: float = 0.995):
    """``y[n] = x[n] - x[n-1] + R*y[n-1]`` (feedback_waveshaper.rs:262-271)."""
    x_prev = _shift1(x, state.x1)
    y = gscan.linrec1(jnp.full_like(x, coeff), x - x_prev, state.y1)
    return DCBlockState(x1=x[..., -1], y1=y[..., -1]), y


# --- RBJ biquads (Direct Form I) ----------------------------------------------


class BiquadState(NamedTuple):
    """DF-I delay line: x1, x2, y1, y2 (slice-shaped)."""

    x1: jnp.ndarray
    x2: jnp.ndarray
    y1: jnp.ndarray
    y2: jnp.ndarray

    @staticmethod
    def init(shape=()) -> "BiquadState":
        z = jnp.zeros(shape, jnp.float32)
        return BiquadState(z, z, z, z)


def rbj_highpass_coeffs(freq, q, sample_rate: float):
    """RBJ highpass (biquad_highpass.rs:85-104).  Returns (b0,b1,b2,a1,a2)."""
    omega = 2.0 * PI * freq / sample_rate
    sin_o, cos_o = jnp.sin(omega), jnp.cos(omega)
    alpha = sin_o / (2.0 * q)
    a0 = 1.0 + alpha
    b0 = (1.0 + cos_o) / 2.0 / a0
    b1 = -(1.0 + cos_o) / a0
    b2 = (1.0 + cos_o) / 2.0 / a0
    a1 = -2.0 * cos_o / a0
    a2 = (1.0 - alpha) / a0
    return b0, b1, b2, a1, a2


def rbj_bandpass_coeffs(freq, q, gain, sample_rate: float):
    """RBJ constant-gain bandpass (biquad_bandpass.rs:90-120)."""
    nyquist = sample_rate * 0.5
    freq = jnp.clip(freq, 20.0, nyquist * 0.95)
    q = jnp.clip(q, 0.1, 100.0)
    omega = 2.0 * PI * freq / sample_rate
    sin_o, cos_o = jnp.sin(omega), jnp.cos(omega)
    alpha = sin_o / (2.0 * q)
    a0 = 1.0 + alpha
    b0 = q * alpha * gain / a0
    b1 = jnp.zeros_like(b0)
    b2 = -q * alpha * gain / a0
    a1 = -2.0 * cos_o / a0
    a2 = (1.0 - alpha) / a0
    return b0, b1, b2, a1, a2


def biquad_df1_block(state: BiquadState, x, coeffs, reset=None):
    """Direct Form I biquad over a block with per-sample coefficients.

    ``y[n] = b0 x[n] + b1 x[n-1] + b2 x[n-2] - a1 y[n-1] - a2 y[n-2]``
    (biquad_highpass.rs:110-125).  The feed-forward FIR side vectorizes with
    shifts; the feedback side is a 2-state recurrence solved by linrec2 with
    ``A = [[-a1, -a2], [1, 0]]``.  Output flushes denormals (state keeps the
    unflushed value, matching the reference).

    Returns ``(new_state, y)``.
    """
    b0, b1, b2, a1, a2 = coeffs
    b0, b1, b2, a1, a2, x = jnp.broadcast_arrays(b0, b1, b2, a1, a2, x)
    x_prev1 = _shift1(x, state.x1)
    x_prev2 = _shift1(x_prev1, state.x2)
    if reset is not None:
        # delay line cleared at reset: x1 is 0 at the reset sample, x2 is 0
        # at the reset sample and the one after it
        keepm = jnp.where(reset, 0.0, 1.0)
        reset_prev = _shift1(jnp.asarray(reset), jnp.zeros_like(state.x1, dtype=bool))
        x_prev1 = x_prev1 * keepm
        x_prev2 = x_prev2 * keepm * jnp.where(reset_prev, 0.0, 1.0)
    w = b0 * x + b1 * x_prev1 + b2 * x_prev2
    A11 = -a1
    A12 = -a2
    ones = jnp.ones_like(a1)
    zeros = jnp.zeros_like(a1)
    if reset is not None:
        A11 = A11 * keepm
        A12 = A12 * keepm
        ones_eff = ones * keepm
    else:
        ones_eff = ones
    y, y2 = gscan.linrec2(A11, A12, ones_eff, zeros, w, zeros, (state.y1, state.y2))
    out = jnp.where(jnp.abs(y) < 1e-15, 0.0, y)
    new_state = BiquadState(
        x1=x[..., -1], x2=x_prev1[..., -1], y1=y[..., -1], y2=y2[..., -1]
    )
    return new_state, out


# --- Membrane resonator ---------------------------------------------------------

#: Max patch preset 1 (gain, freq_hz, q) rows (membrane_resonator.rs:13-19)
MEMBRANE_PARAMS = np.array(
    [
        [275.0, 165.0, 376.0],
        [220.0, 228.0, 205.0],
        [79.0, 294.0, 143.0],
        [65.0, 320.0, 129.0],
        [57.0, 326.0, 141.0],
    ],
    np.float32,
)


class MembraneState(NamedTuple):
    """5 parallel bandpass filters + ring-level follower."""

    biquads: BiquadState      # fields shaped [..., 5]
    ring_level: jnp.ndarray   # [...]

    @staticmethod
    def init(shape=()) -> "MembraneState":
        return MembraneState(
            biquads=BiquadState.init(tuple(shape) + (5,)),
            ring_level=jnp.zeros(shape, jnp.float32),
        )


def membrane_block(state: MembraneState, x, q_scale, gain_scale, sample_rate,
                   reset=None):
    """5-band parallel resonator bank with tanh soft clip and ring follower.

    membrane_resonator.rs:147-203: out = tanh(sum of 5 reson filters);
    ring_level = 0.999*ring + 0.001*|out|.  ``q_scale``/``gain_scale`` are
    per-voice arrays (broadcast against x without the sample axis).

    Returns ``(new_state, out, ring_level_traj)``.
    """
    # all 5 bands as one batched biquad: the band axis folds into the batch
    # dims, so the recurrence is ONE linrec2 call instead of a Python loop
    # of five
    gains = jnp.asarray(MEMBRANE_PARAMS[:, 0])          # [5]
    freqs = jnp.asarray(MEMBRANE_PARAMS[:, 1])
    qs = jnp.asarray(MEMBRANE_PARAMS[:, 2])
    scaled_q = jnp.clip(qs * q_scale[..., None], 0.1, 100.0)       # [..., 5]
    scaled_gain = gains * gain_scale[..., None]                    # [..., 5]
    coeffs = rbj_bandpass_coeffs(
        freqs[:, None], scaled_q[..., None], scaled_gain[..., None], sample_rate
    )                                                              # [..., 5, 1]
    x5 = jnp.expand_dims(x, -2)                                    # [..., 1, B]
    reset5 = None
    if reset is not None:
        reset5 = jnp.broadcast_to(
            jnp.expand_dims(jnp.asarray(reset), -2),
            jnp.broadcast_shapes(x5.shape, coeffs[0].shape)
        )
    new_bq, y = biquad_df1_block(state.biquads, x5, coeffs, reset=reset5)
    total = jnp.sum(y, axis=-2)
    clipped = jnp.tanh(total)
    a = jnp.full_like(clipped, 0.999)
    if reset is not None:
        a = jnp.where(reset, 0.0, a)
    ring = gscan.linrec1(a, 0.001 * jnp.abs(clipped), state.ring_level)
    new_state = MembraneState(biquads=new_bq, ring_level=ring[..., -1])
    return new_state, clipped, ring


def membrane_fade(ring_level):
    """Smooth fade multiplier from ring level (membrane_resonator.rs:162-180)."""
    FADE_START, FADE_END = 0.005, 0.0001
    frac = (ring_level - FADE_END) / (FADE_START - FADE_END)
    return jnp.clip(frac, 0.0, 1.0)


# --- Chamberlin SVF (snare tone shaping) --------------------------------------


class ChamberlinState(NamedTuple):
    low: jnp.ndarray
    band: jnp.ndarray

    @staticmethod
    def init(shape=()) -> "ChamberlinState":
        z = jnp.zeros(shape, jnp.float32)
        return ChamberlinState(low=z, band=z)


def chamberlin_block(state: ChamberlinState, x, cutoff_hz, resonance, sample_rate, reset=None):
    """Chamberlin SVF, 2x-iterated per sample (state_variable.rs:53-91).

    ``f = 2 sin(pi * min(fc/sr, 0.45))``, ``q = 1/max(resonance, 0.5)``; each
    audio sample runs the core update twice with the same input for
    stability.  Per sample the two iterations compose into one affine map on
    (low, band), which linrec2 runs sample by sample.

    Returns (state, low, band, high, notch) — the post-update taps, matching
    `process_all` / `process_mode` (filter_type 0=LP 1=BP 2=HP 3=notch).
    """
    ratio = jnp.minimum(jnp.clip(cutoff_hz, 20.0, 20_000.0) / sample_rate, 0.45)
    f = 2.0 * jnp.sin(PI * ratio)
    qq = 1.0 / jnp.maximum(resonance, 0.5)
    f, qq, x = jnp.broadcast_arrays(f, qq, x)

    # one Chamberlin iteration as affine map on s=(low, band) with input x:
    #   low'  = low + f*band
    #   high  = x - low' - q*band
    #   band' = band + f*high = f*x + (1 - f*q)*band - f*low'
    # Compose the iteration with itself symbolically:
    def step_mats(f, qq):
        # s' = M s + k x  for a single iteration
        m11 = jnp.ones_like(f)
        m12 = f
        m21 = -f
        m22 = 1.0 - f * qq - f * f
        k1 = jnp.zeros_like(f)
        k2 = f
        return (m11, m12, m21, m22, k1, k2)

    m11, m12, m21, m22, k1, k2 = step_mats(f, qq)
    # composed (twice, same x within the sample — reference feeds the same
    # input to both iterations)
    a11 = m11 * m11 + m12 * m21
    a12 = m11 * m12 + m12 * m22
    a21 = m21 * m11 + m22 * m21
    a22 = m21 * m12 + m22 * m22
    b1 = m11 * k1 + m12 * k2 + k1
    b2 = m21 * k1 + m22 * k2 + k2
    b1 = b1 * x
    b2 = b2 * x
    if reset is not None:
        keep = jnp.where(reset, 0.0, 1.0)
        a11, a12, a21, a22 = a11 * keep, a12 * keep, a21 * keep, a22 * keep
    s1, s2 = gscan.linrec2(a11, a12, a21, a22, b1, b2, (state.low, state.band))
    low_prev = _shift1(s1, state.low)
    band_prev = _shift1(s2, state.band)
    if reset is not None:
        low_prev = jnp.where(reset, 0.0, low_prev)
        band_prev = jnp.where(reset, 0.0, band_prev)
    # outputs from the *second* iteration of each sample
    lo1 = low_prev + f * band_prev
    hi1 = x - lo1 - qq * band_prev
    ba1 = band_prev + f * hi1
    lo2 = lo1 + f * ba1
    hi2 = x - lo2 - qq * ba1
    ba2 = ba1 + f * hi2
    notch = hi2 + lo2
    return ChamberlinState(low=s1[..., -1], band=s2[..., -1]), lo2, ba2, hi2, notch
