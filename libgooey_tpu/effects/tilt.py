"""TiltFilterEffect: one-knob LP↔HP sweep with center crossfade.

Behavioral reference: src/effects/tilt_filter.rs (303 LoC).

* knob < 0.5: low-pass region — mix = 1-2k, freq sweeps 80 Hz→20 kHz log;
* knob > 0.5: high-pass region — mix = 2(k-0.5), freq sweeps 20 Hz→8 kHz log;
* resonance → Q = 0.5 + res*8; TPT SVF core; out = dry*(1-mix) + tap*mix;
* passthrough when mix < 0.001 (filter state frozen).
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
import numpy as np

from libgooey_tpu.core.smoother import SmootherBank, smoothing_coeff
from libgooey_tpu.ops import filters

LP_FREQ = (80.0, 20000.0)
HP_FREQ = (20.0, 8000.0)

P_CUTOFF, P_RES = range(2)


class TiltState(NamedTuple):
    svf: filters.SVFState  # [2]
    smooth: SmootherBank   # [2, 2]


def init_state(sample_rate: float, cutoff=0.5, resonance=0.0) -> TiltState:
    vals = np.array([[np.clip(cutoff, 0, 1), np.clip(resonance, 0, 1)]] * 2, np.float32)
    return TiltState(svf=filters.SVFState.init((2,)), smooth=SmootherBank.init(vals))


def process_block(state: TiltState, x, targets, *, sample_rate: float):
    """One block of the stereo tilt filter → ``(new_state, out[2, B])``."""
    B = x.shape[-1]
    coeff = smoothing_coeff(sample_rate, 30.0)
    bank = state.smooth.with_targets(
        jnp.broadcast_to(jnp.asarray(targets, jnp.float32), (2, 2))
    )
    # exact passthrough freeze at block granularity (tilt_filter.rs:114-115
    # holds the SVF; see effects/freeze.py).  Passthrough <=> mix = |2k-1| <
    # 0.001; the knob trajectory is monotone, so the whole block sits inside
    # the center window iff its first and last samples do.
    from libgooey_tpu.effects import freeze as frz

    q = jnp.float32(1.0 - coeff)
    _delta = bank.current[:, P_CUTOFF] - bank.target[:, P_CUTOFF]
    _d1, _dB = _delta * q, _delta * q ** jnp.float32(B)
    _k_first = bank.target[:, P_CUTOFF] + jnp.where(jnp.abs(_d1) < 1e-4, 0.0, _d1)
    _k_last = bank.target[:, P_CUTOFF] + jnp.where(jnp.abs(_dB) < 1e-4, 0.0, _dB)
    held = (jnp.abs(2.0 * _k_first - 1.0) < 0.001) & (
        jnp.abs(2.0 * _k_last - 1.0) < 0.001)

    # coefficient streams as exp(log(q)*n) instead of power, and
    # exp(log(ratio)*t) maps (the SVF rings at Q up to 8.5, so a 1-ulp
    # coefficient difference is audible)
    n1 = jnp.arange(1, B + 1, dtype=jnp.float32)
    powers = jnp.exp(np.float32(np.log(1.0 - coeff)) * n1)

    def traj(idx):
        tgt = bank.target[:, idx, None]
        d = (bank.current[:, idx] - bank.target[:, idx])[:, None] * powers
        return tgt + jnp.where(jnp.abs(d) < 1e-4, 0.0, d)

    knob = traj(P_CUTOFF)
    res = traj(P_RES)

    lp_mix = 1.0 - knob * 2.0
    lp_freq = LP_FREQ[0] * jnp.exp(
        np.float32(np.log(LP_FREQ[1] / LP_FREQ[0])) * (knob * 2.0))
    hp_mix = (knob - 0.5) * 2.0
    hp_freq = HP_FREQ[0] * jnp.exp(
        np.float32(np.log(HP_FREQ[1] / HP_FREQ[0])) * ((knob - 0.5) * 2.0))

    use_lp = knob < 0.5
    mix = jnp.where(use_lp, lp_mix, hp_mix)
    freq = jnp.where(use_lp, lp_freq, hp_freq)
    q = 0.5 + res * 8.0
    passthrough = mix < 0.001

    svf_state, lp, _bp, hp = filters.svf_tpt_outputs(
        state.svf, x, freq, q, sample_rate,
        reset=None,
    )
    wet = jnp.where(use_lp, lp, hp)
    out = jnp.where(passthrough, x, x * (1.0 - mix) + wet * mix)
    out = jnp.where(jnp.isfinite(out), out, 0.0)
    out = jnp.where(jnp.abs(out) < 1e-15, 0.0, out)

    # the reference freezes SVF state in passthrough; all-passthrough blocks
    # hold it exactly (``held`` above), so only center-crossing boundary
    # blocks deviate — pinned by tests/test_state_freeze.py
    new_state = TiltState(
        svf=frz.hold_where(held, state.svf, svf_state),
        smooth=SmootherBank(
            current=jnp.stack([knob[:, -1], res[:, -1]], axis=-1), target=bank.target
        ),
    )
    return new_state, out
