"""LowpassFilterEffect: Moog-ish two-pole LP with tanh'd resonance feedback.

Behavioral reference: src/effects/lowpass_filter.rs (394 LoC).

    g = clamp(1 - e^(-2pi*fc/fs), 0, 0.9)        fc capped at 0.40*sr
    res_eff = res * (1 - min(fc/5000, 1)^2 * 0.7)
    fb = res_eff * 3.5
    in' = x - tanh(stage2*fb) * min(fb, 1)
    stage1 += g*(in' - stage1); stage2 += g*(stage1 - stage2)
    out = tanh(stage2)

The tanh inside the feedback loop makes this a true nonlinear recurrence —
it runs as a sequential scan (bus effect: only 2 lanes, one scan per block).
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
import numpy as np

from libgooey_tpu.core.smoother import SmootherBank, smoothing_coeff
from libgooey_tpu.ops import scan as gscan

P_CUTOFF, P_RES = range(2)
CUTOFF_RANGE = (20.0, 20000.0)


class LowpassState(NamedTuple):
    stages: jnp.ndarray    # [2, 2] (stage1, stage2) per channel
    smooth: SmootherBank   # [2, 2]


def init_state(sample_rate: float, cutoff=8000.0, resonance=0.2) -> LowpassState:
    vals = np.array(
        [[np.clip(cutoff, *CUTOFF_RANGE), np.clip(resonance, 0.0, 0.95)]] * 2,
        np.float32,
    )
    return LowpassState(stages=jnp.zeros((2, 2), jnp.float32), smooth=SmootherBank.init(vals))


def ladder_step(stages, xs):
    """One sample of the two-pole ladder with tanh'd resonance feedback."""
    xn, gn, fbn = xs
    s1, s2 = stages
    infb = xn - jnp.tanh(s2 * fbn) * jnp.minimum(fbn, 1.0)
    s1 = s1 + gn * (infb - s1)
    s2 = s2 + gn * (s1 - s2)
    s1 = jnp.where(jnp.abs(s1) < 1e-15, 0.0, s1)
    s2 = jnp.where(jnp.abs(s2) < 1e-15, 0.0, s2)
    out = jnp.tanh(s2)
    ok = jnp.isfinite(out)
    return ((jnp.where(ok, s1, 0.0), jnp.where(ok, s2, 0.0)),
            jnp.where(ok, out, 0.0))


def process_block(state: LowpassState, x, targets, *, sample_rate: float):
    """One block of the stereo resonant LP → ``(new_state, out[2, B])``."""
    B = x.shape[-1]
    x = jnp.where(jnp.isfinite(x), x, 0.0)
    coeff = smoothing_coeff(sample_rate, 30.0)
    bank = state.smooth.with_targets(
        jnp.broadcast_to(jnp.asarray(targets, jnp.float32), (2, 2))
    )
    powers = jnp.power(np.float32(1.0 - coeff), jnp.arange(1, B + 1, dtype=jnp.float32))

    def traj(idx):
        tgt = bank.target[:, idx, None]
        d = (bank.current[:, idx] - bank.target[:, idx])[:, None] * powers
        return tgt + jnp.where(jnp.abs(d) < 1e-4, 0.0, d)

    cutoff = jnp.minimum(traj(P_CUTOFF), sample_rate * 0.40)
    res = traj(P_RES)
    g = jnp.clip(1.0 - jnp.exp(-2.0 * np.pi * cutoff / sample_rate), 0.0, 0.90)
    freq_ratio = jnp.minimum(cutoff / 5000.0, 1.0)
    res_eff = res * (1.0 - freq_ratio * freq_ratio * 0.7)
    fb = res_eff * 3.5

    (s1, s2), out = gscan.nonlinear_scan(
        ladder_step, (state.stages[:, 0], state.stages[:, 1]), (x, g, fb))
    stages = jnp.stack([s1, s2], axis=-1)

    new_state = LowpassState(
        stages=stages,
        smooth=SmootherBank(
            current=jnp.stack([traj(P_CUTOFF)[:, -1], res[:, -1]], axis=-1),
            target=bank.target,
        ),
    )
    return new_state, out
