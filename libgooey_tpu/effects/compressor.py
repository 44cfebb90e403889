"""TubeCompressor: peak-detector compressor with soft knee and tube coloring.

Behavioral reference: src/effects/compressor.rs (561 LoC).

* peak envelope follower with attack/release ballistics
  (coeff = e^(-1/(ms*sr)), attack 0.1-100 ms, release 5-1000 ms);
* log-domain gain with a 6 dB quadratic soft knee; ratio 1-20,
  threshold -60..0 dB;
* one-pole gain smoothing (0.05);
* atan tube coloring (x*2/pi*1.1) engaged when gain < 0.99 but always fed to
  keep the oversampler history warm; DC blocker (0.995); dry/wet mix;
* external sidechain: the detector tracks `sidechain` while gain applies to
  `input` (process_with_sidechain, compressor.rs:230-247).

Block mapping: the detector's attack/release switch is the only nonlinear
recurrence — a short sequential scan over the (independent) sidechain; the
gain smoother and DC blocker are linear scans; everything else vectorizes.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
import numpy as np

from libgooey_tpu.core.smoother import SmootherBank, smoothing_coeff
from libgooey_tpu.ops import oversample as ovs_mod
from libgooey_tpu.ops import scan as gscan
from libgooey_tpu.ops.filters import DCBlockState, _shift1, dc_block

KNEE_DB = 6.0
HALF_KNEE_DB = 3.0
FRAC_2_PI = float(2.0 / np.pi)

PARAMS = ("threshold_db", "ratio", "attack_ms", "release_ms", "mix")
P_THRESH, P_RATIO, P_ATTACK, P_RELEASE, P_MIX = range(5)
RANGES = ((-60.0, 0.0), (1.0, 20.0), (0.1, 100.0), (5.0, 1000.0), (0.0, 1.0))


class CompressorState(NamedTuple):
    envelope: jnp.ndarray       # [2]
    gain: jnp.ndarray           # [2] smoothed gain (init 1)
    dc: DCBlockState            # [2]
    smooth: SmootherBank        # [2, 5]
    ovs: ovs_mod.OversamplerState  # [2, ...] tube-coloring oversampler


def init_state(sample_rate: float, threshold_db=-20.0, ratio=4.0, attack_ms=10.0,
               release_ms=100.0, mix=1.0) -> CompressorState:
    vals = np.array(
        [[np.clip(threshold_db, *RANGES[0]), np.clip(ratio, *RANGES[1]),
          np.clip(attack_ms, *RANGES[2]), np.clip(release_ms, *RANGES[3]),
          np.clip(mix, *RANGES[4])]] * 2, np.float32,
    )
    return CompressorState(
        envelope=jnp.zeros(2, jnp.float32),
        gain=jnp.ones(2, jnp.float32),
        dc=DCBlockState.init((2,)),
        smooth=SmootherBank.init(vals),
        ovs=ovs_mod.OversamplerState.init((2,)),
    )


def gain_reduction_db(over_db, ratio):
    """6 dB quadratic soft knee (compressor.rs:101-116)."""
    slope = 1.0 - 1.0 / ratio
    knee = jnp.square(over_db + HALF_KNEE_DB) / (2.0 * KNEE_DB) * slope
    return jnp.where(
        over_db <= -HALF_KNEE_DB, 0.0,
        jnp.where(over_db >= HALF_KNEE_DB, over_db * slope, knee),
    )


def detector_step(env, xs):
    """One sample of the attack/release peak detector (rs:96-99)."""
    r, ac, rc, byp = xs
    c = jnp.where(r > env, ac, rc)
    new = c * env + (1.0 - c) * r
    new = jnp.where(new < 1e-15, 0.0, new)
    new = jnp.where(byp, env, new)
    return new, new


def process_block(
    state: CompressorState,
    x,                 # [2, B]
    targets,           # [5]
    *,
    sample_rate: float,
    sidechain=None,    # optional [2, B] detector source
    os_mode: int = 4,
):
    """One block of the stereo compressor → ``(new_state, out[2, B])``."""
    B = x.shape[-1]
    x = jnp.where(jnp.isfinite(x), x, 0.0)
    sc = x if sidechain is None else jnp.where(jnp.isfinite(sidechain), sidechain, 0.0)

    coeff = smoothing_coeff(sample_rate, 30.0)
    bank = state.smooth.with_targets(
        jnp.broadcast_to(jnp.asarray(targets, jnp.float32), (2, 5))
    )
    powers = jnp.power(np.float32(1.0 - coeff), jnp.arange(1, B + 1, dtype=jnp.float32))

    def traj(idx):
        tgt = bank.target[:, idx, None]
        d = (bank.current[:, idx] - bank.target[:, idx])[:, None] * powers
        return tgt + jnp.where(jnp.abs(d) < 1e-4, 0.0, d)

    thr = traj(P_THRESH)
    ratio = traj(P_RATIO)
    att_ms = traj(P_ATTACK)
    rel_ms = traj(P_RELEASE)
    mix = traj(P_MIX)
    bypass = mix < 1e-4

    # detector: attack/release envelope follower (sequential over B)
    att_c = jnp.exp(-1.0 / (att_ms * 0.001 * sample_rate))
    rel_c = jnp.exp(-1.0 / (rel_ms * 0.001 * sample_rate))
    rect = jnp.abs(sc)

    env_state, env = gscan.nonlinear_scan(
        detector_step, state.envelope, (rect, att_c, rel_c, bypass)
    )

    env_db = 20.0 * jnp.log10(env + 1e-20)
    gr_db = gain_reduction_db(env_db - thr, ratio)
    gain_lin = jnp.power(10.0, -gr_db * 0.05)

    # gain smoothing: g += 0.05*(target - g), frozen on bypass
    a = jnp.where(bypass, 1.0, 0.95)
    b = jnp.where(bypass, 0.0, 0.05 * gain_lin)
    gain = gscan.linrec1(a, b, state.gain)

    compressed = x * gain

    def color_fn(v):
        return jnp.arctan(v) * (FRAC_2_PI * 1.1)

    # always fed so the half-band history stays warm (compressor.rs:197-199)
    new_ovs, colored_os = ovs_mod.process(state.ovs, color_fn, compressed, os_mode)
    colored = jnp.where(gain < 0.99, colored_os, compressed)

    # DC blocker frozen on bypass
    x1 = gscan.linrec1(
        jnp.where(bypass, 1.0, 0.0), jnp.where(bypass, 0.0, colored), state.dc.x1
    )
    x1_prev = _shift1(x1, state.dc.x1)
    y1 = gscan.linrec1(
        jnp.where(bypass, 1.0, 0.995),
        jnp.where(bypass, 0.0, colored - x1_prev),
        state.dc.y1,
    )
    out = jnp.where(bypass, x, x * (1.0 - mix) + y1 * mix)
    out = jnp.where(jnp.isfinite(out), out, 0.0)

    new_state = CompressorState(
        envelope=env_state,
        gain=gain[:, -1],
        dc=DCBlockState(x1=x1[:, -1], y1=y1[:, -1]),
        ovs=new_ovs,
        smooth=SmootherBank(
            current=jnp.stack(
                [thr[:, -1], ratio[:, -1], att_ms[:, -1], rel_ms[:, -1], mix[:, -1]],
                axis=-1,
            ),
            target=bank.target,
        ),
    )
    return new_state, out
