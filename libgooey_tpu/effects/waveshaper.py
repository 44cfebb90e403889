"""Waveshaper: tanh soft-clip with drive compensation (Max overdrive~ style).

Behavioral reference: src/effects/waveshaper.rs — per sample:

    compensation = tanh(0.5) / tanh(0.5 * drive)
    out = x*(1-mix) + tanh(x*drive)*compensation * mix

Bypass (identity) when drive <= 1 or mix <= 1e-4.  The nonlinearity is
memoryless; pass ``oversample`` (e.g. ``ops.oversample.stateful(...)[0]``)
to evaluate it at 2x/4x through the half-band chains — the reference's
Waveshaper defaults to 4x (waveshaper.rs:32).
"""

from __future__ import annotations

import jax.numpy as jnp

from libgooey_tpu.ops.oversample import repeat_to_rate


def process(x, drive, mix=1.0, oversample=None):
    """Apply the waveshaper over arbitrary-shape blocks (broadcasting)."""
    drive = jnp.asarray(drive, jnp.float32)
    mix = jnp.asarray(mix, jnp.float32)
    B = x.shape[-1]

    def fn(v):
        d = jnp.maximum(repeat_to_rate(drive, v, B), 1.0 + 1e-6)
        compensation = jnp.tanh(0.5) / jnp.tanh(0.5 * d)
        return jnp.tanh(v * d) * compensation

    saturated = fn(x) if oversample is None else oversample(fn, x)
    wet = x * (1.0 - mix) + saturated * mix
    bypass = (mix <= 1e-4) | (drive <= 1.0)
    out = jnp.where(bypass, x, wet)
    return jnp.where(jnp.isfinite(x), out, 0.0)
