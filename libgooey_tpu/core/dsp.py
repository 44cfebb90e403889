"""Small stateless DSP math shared everywhere.

Behavioral reference: src/frame.rs (equal-power pan / downmix) and
src/utils/mod.rs (tuning_to_multiplier, cubic_interpolate, raised_sine_window).
All functions are pure, shape-polymorphic jnp ops, usable inside jit/vmap and
kernels alike.

Stereo convention: this framework keeps the channel axis *leading* —
``[2, ...]`` — so the trailing (lane) axis stays the long sample/voice axis
for the device layout.  A "stereo frame stream" is an array of shape ``[2, B]``.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

HALF_PI = float(np.pi / 2.0)


def pan_gains(pan):
    """Equal-power pan gains for ``pan`` in [0, 1] (0=L, 0.5=center, 1=R).

    Returns ``(gain_l, gain_r)`` with constant power (center is −3 dB per
    channel).  Reference: src/frame.rs:31-37 (`StereoFrame::panned`).
    """
    angle = jnp.clip(pan, 0.0, 1.0) * HALF_PI
    return jnp.cos(angle), jnp.sin(angle)


def panned(x, pan):
    """Pan mono ``x[...]`` into stereo ``[2, ...]`` with the equal-power law."""
    gl, gr = pan_gains(pan)
    return jnp.stack([x * gl, x * gr], axis=0)


def mono(x):
    """Place a mono signal equally on both channels (the "stereo seam").

    Reference: src/frame.rs:23 (`StereoFrame::mono`).
    """
    return jnp.stack([x, x], axis=0)


def downmix(stereo):
    """Average a ``[2, ...]`` stereo stream to mono.  src/frame.rs:42-44."""
    return 0.5 * (stereo[0] + stereo[1])


def tuning_to_multiplier(normalized):
    """Normalized tuning (0..1) → frequency multiplier (0.5x .. 2.0x).

    0.0 → −12 semitones, 0.5 → neutral, 1.0 → +12 semitones.
    Reference: src/utils/mod.rs:14-17.
    """
    semitones = (jnp.clip(normalized, 0.0, 1.0) - 0.5) * 24.0
    return jnp.exp2(semitones * (1.0 / 12.0))


def cubic_interpolate(p0, p1, p2, p3, t):
    """4-point Catmull-Rom interpolation between ``p1`` and ``p2``.

    Reference: src/utils/mod.rs:26-32.  Shared by sample-buffer readers
    (granular + loop playback).
    """
    a0 = -0.5 * p0 + 1.5 * p1 - 1.5 * p2 + 0.5 * p3
    a1 = p0 - 2.5 * p1 + 2.0 * p2 - 0.5 * p3
    a2 = -0.5 * p0 + 0.5 * p2
    a3 = p1
    return ((a0 * t + a1) * t + a2) * t + a3


def raised_sine_window(phase, shape):
    """``sin(pi*phase).max(0)**shape`` for phase in [0,1]; shape 2 == Hann.

    Reference: src/utils/mod.rs:39-44.  Shared by granulator grain envelopes
    and the WSOLA time-stretcher windows.
    """
    s = jnp.maximum(jnp.sin(np.pi * jnp.clip(phase, 0.0, 1.0)), 0.0)
    return jnp.power(s, shape)


def denormalize(normalized, lo, hi):
    """Map a normalized 0-1 value into [lo, hi] (clamping the input).

    Reference: src/instruments/kick.rs:48-52 (ranges::denormalize) — the same
    linear map is used by every instrument's `ranges` module.
    """
    return lo + jnp.clip(normalized, 0.0, 1.0) * (hi - lo)


def normalize(value, lo, hi):
    """Inverse of :func:`denormalize` (clamped).  kick.rs:55-59."""
    return jnp.clip((value - lo) / (hi - lo), 0.0, 1.0)


def flush_denormals(x, eps=1e-15):
    """Flush tiny values to zero, mirroring the reference's denormal guards.

    This is mostly about matching reference behavior in feedback loops
    (e.g. src/filters/resonant_lowpass.rs:55-60 flushes |v2| < 1e-15).
    """
    return jnp.where(jnp.abs(x) < eps, 0.0, x)
