"""TubeSaturation: asymmetric atan saturation with second-harmonic warmth.

Behavioral reference: src/effects/saturation.rs (382 LoC).

    driven = x * (1 + drive*7)
    biased = driven + bias*|driven|          bias = warmth*0.4
    soft   = atan(biased) * 2/pi
    sat    = soft + soft^2*sign(soft)*0.15*bias
    out    = x*(1-mix) + dc_block(sat)*mix   (bypass when mix < 1e-4)

Memoryless apart from the DC blocker — fully vectorized.  The transfer
curve is evaluated through the polyphase half-band oversampler at
``os_mode``× (reference default 4x, saturation.rs:79).  Deviation: the
reference's early-return bypass freezes the oversampler history; here it
keeps running (sub-audible transient difference on re-engage).
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
import numpy as np

from libgooey_tpu.core.smoother import SmootherBank, smoothing_coeff
from libgooey_tpu.ops import oversample as ovs_mod
from libgooey_tpu.ops import scan as gscan
from libgooey_tpu.ops.filters import DCBlockState, _shift1

FRAC_2_PI = float(2.0 / np.pi)

PARAMS = ("drive", "warmth", "mix")
P_DRIVE, P_WARMTH, P_MIX = range(3)


class SaturationState(NamedTuple):
    dc: DCBlockState      # [2]
    smooth: SmootherBank  # [2, 3]
    ovs: ovs_mod.OversamplerState  # [2, ...]


def init_state(sample_rate: float, drive=0.3, warmth=0.3, mix=1.0) -> SaturationState:
    vals = np.array([[np.clip(drive, 0, 1), np.clip(warmth, 0, 1),
                      np.clip(mix, 0, 1)]] * 2, np.float32)
    return SaturationState(dc=DCBlockState.init((2,)), smooth=SmootherBank.init(vals),
                           ovs=ovs_mod.OversamplerState.init((2,)))


repeat_to_rate = ovs_mod.repeat_to_rate


def saturate(x, drive, bias):
    """The tube transfer curve (saturation.rs:106-125)."""
    driven = x * drive
    biased = driven + bias * jnp.abs(driven)
    soft = jnp.arctan(biased) * FRAC_2_PI
    second = jnp.square(soft) * jnp.sign(soft) * 0.15
    return soft + second * bias


def process_block(state: SaturationState, x, targets, *, sample_rate: float,
                  os_mode: int = 4):
    """One block of the stereo saturator → ``(new_state, out[2, B])``."""
    B = x.shape[-1]
    x = jnp.where(jnp.isfinite(x), x, 0.0)
    coeff = smoothing_coeff(sample_rate, 30.0)
    bank = state.smooth.with_targets(
        jnp.broadcast_to(jnp.asarray(targets, jnp.float32), (2, 3))
    )
    # exact bypass freeze at block granularity (saturation.rs:230-232 holds
    # the oversampler history; see effects/freeze.py)
    from libgooey_tpu.effects import freeze as frz

    held = frz.traj_all_below(
        bank.current[:, P_MIX], bank.target[:, P_MIX],
        jnp.float32(1.0 - coeff), B, 1e-4)

    powers = jnp.power(np.float32(1.0 - coeff), jnp.arange(1, B + 1, dtype=jnp.float32))

    def traj(idx):
        tgt = bank.target[:, idx, None]
        d = (bank.current[:, idx] - bank.target[:, idx])[:, None] * powers
        return tgt + jnp.where(jnp.abs(d) < 1e-4, 0.0, d)

    drive = 1.0 + traj(P_DRIVE) * 7.0
    bias = traj(P_WARMTH) * 0.4
    mix = traj(P_MIX)
    bypass = mix < 1e-4

    def fn(v):
        return saturate(
            v, repeat_to_rate(drive, v, B), repeat_to_rate(bias, v, B)
        )

    new_ovs, sat = ovs_mod.process(state.ovs, fn, x, os_mode)

    x1 = gscan.linrec1(
        jnp.where(bypass, 1.0, 0.0), jnp.where(bypass, 0.0, sat), state.dc.x1
    )
    x1_prev = _shift1(x1, state.dc.x1)
    y1 = gscan.linrec1(
        jnp.where(bypass, 1.0, 0.995), jnp.where(bypass, 0.0, sat - x1_prev),
        state.dc.y1,
    )
    dc_state = DCBlockState(x1=x1[:, -1], y1=y1[:, -1])

    out = jnp.where(bypass, x, x * (1.0 - mix) + y1 * mix)
    out = jnp.where(jnp.isfinite(out), out, 0.0)

    new_state = SaturationState(
        dc=dc_state,
        ovs=frz.hold_where(held, state.ovs, new_ovs),
        smooth=SmootherBank(
            current=jnp.stack(
                [(drive[:, -1] - 1.0) / 7.0, bias[:, -1] / 0.4, mix[:, -1]], axis=-1
            ),
            target=bank.target,
        ),
    )
    return new_state, out
