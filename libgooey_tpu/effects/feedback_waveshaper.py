"""Feedback waveshaper: tanh distortion with a filtered feedback loop.

Behavioral reference: src/effects/feedback_waveshaper.rs.  Signal path per
sample:

    fb_in   = drive*x + feedback*last_out
    shaped  = tanh(fb_in)                       (oversampled in the reference)
    env    += (1-c)(|x| - env)                  c = attack/release by direction
    comp    = gain_compensation(env, drive, feedback)   (clamped at 3x)
    dc      = dc_block(shaped*comp)
    filt   += g*(dc - filt);  last_out = filt
    out     = x*(1-mix) + dc*mix

Bypass when mix <= 1e-4 or drive <= 1 (state frozen).  NaN input resets
state; |last_out| > 50 resets and passes the input through.

Block mapping: two paths, chosen statically by the caller:

* ``feedback=0`` fast path (every factory preset): the nonlinearity is
  feed-forward, so tanh/compensation vectorize over ``[V, B]``; only the
  envelope follower (attack/release switching — genuinely nonlinear) runs as
  a short sequential scan, and the DC-blocker/feedback filter collapse to
  associative scans.
* general path: the loop is a true nonlinear recurrence; runs via
  ``nonlinear_scan`` (a per-sample loop carrying 5 per-voice floats).

The tanh runs through the polyphase half-band oversampler at ``os_mode``×
(reference default 4x) on the fast path.  Deviation: the general feedback
path evaluates the tanh at the engine rate — oversampling inside a true
per-sample feedback recurrence would put four half-band chains in the
sequential scan carry for an alias improvement that is masked by the
feedback filter's own low-pass.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax.numpy as jnp
import numpy as np

from libgooey_tpu.ops import oversample as ovs_mod
from libgooey_tpu.ops import scan as gscan
from libgooey_tpu.ops.filters import _shift1

DC_COEFF = 0.995
ENV_ATTACK_MS = 1.0
ENV_RELEASE_MS = 120.0
ENV_FLOOR = 0.05
COMP_TAMING = 0.25
HIGH_END_MAKEUP_DB = 5.1
MAX_COMP_GAIN = 3.0
RUNAWAY_LIMIT = 50.0


class FBShaperState(NamedTuple):
    """Per-voice loop state, each slice-shaped ``[...]`` (e.g. ``[V]``)."""

    last_out: jnp.ndarray
    filter_state: jnp.ndarray
    dc_x1: jnp.ndarray
    dc_y1: jnp.ndarray
    env: jnp.ndarray
    ovs: ovs_mod.OversamplerState

    @staticmethod
    def init(shape=()) -> "FBShaperState":
        shape = (shape,) if isinstance(shape, int) else tuple(shape)
        z = jnp.zeros(shape, jnp.float32)
        return FBShaperState(z, z, z, z, z, ovs_mod.OversamplerState.init(shape))


def env_coeffs(sample_rate: float):
    """Attack/release retention factors (feedback_waveshaper.rs:242-244)."""
    att = float(np.exp(-1.0 / (ENV_ATTACK_MS / 1000.0 * sample_rate)))
    rel = float(np.exp(-1.0 / (ENV_RELEASE_MS / 1000.0 * sample_rate)))
    return att, rel


def filter_coeff(cutoff_hz, sample_rate: float):
    """Feedback-path one-pole coefficient, clamped to 0.9 (rs:233-236)."""
    g = 1.0 - jnp.exp(-2.0 * np.pi * cutoff_hz / sample_rate)
    return jnp.clip(g, 0.0, 0.9)


def gain_compensation(env, drive, feedback):
    """Envelope-referenced makeup gain (feedback_waveshaper.rs:247-259)."""
    reference = jnp.maximum(env, ENV_FLOOR)
    driven_ref = jnp.maximum(jnp.abs(jnp.tanh(reference * drive)), 1e-6)
    comp_no_fb = jnp.tanh(reference) / driven_ref

    drive_norm = jnp.clip((drive - 1.0) / 99.0, 0.0, 1.0)
    feedback_norm = jnp.clip(feedback / 0.98, 0.0, 1.0)
    high_end = jnp.power(drive_norm, 1.35) * jnp.power(feedback_norm, 2.0)
    high_end_makeup = jnp.power(10.0, HIGH_END_MAKEUP_DB * high_end / 20.0)

    taming = 1.0 / (1.0 + comp_no_fb * feedback * COMP_TAMING)
    return jnp.minimum(comp_no_fb * taming * high_end_makeup, MAX_COMP_GAIN)


def env_follow_step(env, xs, *, att, rel):
    """One sample of the attack/release follower (rs:242-244).

    env += (1-c)(rect - env) with c chosen by rect > env; denormal flush at
    1e-15.  ``freeze`` masks bypassed samples (state untouched).
    """
    r, frz = xs
    c = jnp.where(r > env, att, rel)
    new = env + (1.0 - c) * (r - env)
    new = jnp.where(jnp.abs(new) < 1e-15, 0.0, new)
    new = jnp.where(frz, env, new)
    return new, new


def _env_follow(env0, rect, att, rel, freeze):
    """Asymmetric attack/release follower: sequential over the block."""
    step = functools.partial(env_follow_step, att=att, rel=rel)
    return gscan.nonlinear_scan(step, env0, (rect, freeze))


def process_block(
    state: FBShaperState,
    x,
    drive,
    feedback,
    fb_filter_coeff,
    mix,
    sample_rate: float,
    feedback_path: bool = True,
    os_mode: int = 4,
):
    """Run the feedback waveshaper over a block ``x[..., B]``.

    ``drive``/``feedback``/``fb_filter_coeff``/``mix`` broadcast against x
    (per-sample trajectories from smoothed params).  ``feedback_path=False``
    selects the vectorized zero-feedback fast path — caller must guarantee
    the feedback parameter is 0 (all reference presets ship 0).
    ``os_mode`` (static): tanh oversampling factor on the fast path.

    Returns ``(new_state, out)``.
    """
    drive, feedback, fbc, mix, x = jnp.broadcast_arrays(
        jnp.asarray(drive, jnp.float32),
        jnp.asarray(feedback, jnp.float32),
        jnp.asarray(fb_filter_coeff, jnp.float32),
        jnp.asarray(mix, jnp.float32),
        x,
    )
    att, rel = env_coeffs(sample_rate)
    bypass = (mix <= 1e-4) | (drive <= 1.0)

    if not feedback_path:
        # --- zero-feedback fast path: feed-forward nonlinearity ------------
        new_ovs, shaped = ovs_mod.process(state.ovs, jnp.tanh, drive * x, os_mode)
        env_state, env = _env_follow(state.env, jnp.abs(x), att, rel, bypass)
        comp = gain_compensation(env, drive, feedback)
        compensated = shaped * comp
        # DC blocker with per-sample freeze on bypass: bypassed samples
        # neither read nor advance state.  Time-varying linear recurrences:
        #   x1[n] = bypass ? x1[n-1] : in[n]
        #   y1[n] = bypass ? y1[n-1] : in[n] - x1[n-1] + R*y1[n-1]
        x1 = gscan.linrec1(
            jnp.where(bypass, 1.0, 0.0), jnp.where(bypass, 0.0, compensated), state.dc_x1
        )
        x1_prev = _shift1(x1, state.dc_x1)
        dc_raw = compensated - x1_prev
        y1 = gscan.linrec1(
            jnp.where(bypass, 1.0, DC_COEFF), jnp.where(bypass, 0.0, dc_raw), state.dc_y1
        )
        dc = jnp.where(bypass, 0.0, y1)
        filt = gscan.linrec1(
            jnp.where(bypass, 1.0, 1.0 - fbc), jnp.where(bypass, 0.0, fbc * dc), state.filter_state
        )
        filt = jnp.where(jnp.abs(filt) < 1e-15, 0.0, filt)
        out = jnp.where(bypass, x, x * (1.0 - mix) + dc * mix)
        from libgooey_tpu.effects import freeze as frz

        new_state = FBShaperState(
            last_out=filt[..., -1],
            filter_state=filt[..., -1],
            dc_x1=x1[..., -1],
            dc_y1=y1[..., -1],
            env=env_state,
            ovs=frz.hold_where(jnp.all(bypass, axis=-1), state.ovs, new_ovs),
        )
        return new_state, out

    # --- general path: true nonlinear recurrence ---------------------------
    def step(st, xs):
        xn, dn, fn_, gn, mn, byp = xs
        last_out, filt, dcx, dcy, env = st
        fb_in = dn * xn + fn_ * last_out
        shaped = jnp.tanh(fb_in)  # engine-rate on the feedback path (see module doc)
        c = jnp.where(jnp.abs(xn) > env, att, rel)
        env_n = env + (1.0 - c) * (jnp.abs(xn) - env)
        env_n = jnp.where(jnp.abs(env_n) < 1e-15, 0.0, env_n)
        comp = gain_compensation(env_n, dn, fn_)
        compensated = shaped * comp
        dc_out = compensated - dcx + DC_COEFF * dcy
        dcy_n = jnp.where(jnp.abs(dc_out) < 1e-15, 0.0, dc_out)
        filt_n = filt + gn * (dc_out - filt)
        filt_n = jnp.where(jnp.abs(filt_n) < 1e-15, 0.0, filt_n)
        # runaway guard (rs:162-165): reset state, pass input through
        runaway = jnp.abs(filt_n) > RUNAWAY_LIMIT
        out = jnp.where(
            runaway, xn, xn * (1.0 - mn) + dc_out * mn
        )
        z = jnp.zeros_like(filt_n)
        new = (
            jnp.where(runaway, z, filt_n),
            jnp.where(runaway, z, filt_n),
            jnp.where(runaway, z, compensated),
            jnp.where(runaway, z, dcy_n),
            jnp.where(runaway, z, env_n),
        )
        # bypass freezes state entirely and passes input through
        new = tuple(jnp.where(byp, old, nv) for old, nv in zip(st, new))
        return new, jnp.where(byp, xn, out)

    st0 = (state.last_out, state.filter_state, state.dc_x1, state.dc_y1, state.env)
    st, out = gscan.nonlinear_scan(step, st0, (x, drive, feedback, fbc, mix, bypass))
    return FBShaperState(*st, ovs=state.ovs), out
