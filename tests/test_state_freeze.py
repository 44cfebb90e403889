"""Masked-branch state-freeze parity.

The reference's bypass paths are early returns that FREEZE all DSP state
(`saturation.rs:230-232`, `waveshaper.rs:55-57`, `feedback_waveshaper.rs:
117-118`, `tilt_filter.rs:114-115`, `bass.rs:846`).  Per-sample recurrences
here freeze with ``jnp.where`` masks on their coefficients (DC blockers,
envelope followers, gain smoothers); the oversampler chains and the tilt
SVF freeze at BLOCK granularity via ``effects/freeze.py``: any bypass span
of whole blocks holds state exactly like the reference, and only boundary
blocks (bypass condition crossing mid-block) deviate — that residual is
bounded by the last test.  Full inventory: PARITY.md §Known deviations.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp

from libgooey_tpu.core.smoother import SmootherBank, smoothing_coeff
from libgooey_tpu.effects import saturation as sat_mod
from libgooey_tpu.effects import tilt as tilt_mod
from libgooey_tpu.effects import feedback_waveshaper as fbws_mod

SR = 44100.0
B = 512


def sig(n, seed, amp=0.4):
    return (np.random.RandomState(seed).randn(2, n) * amp).astype(np.float32)


def settled(state, targets):
    """Force the parameter smoothers to an exact value (current == target)
    so bypass spans start at sample 0 of a block, like the reference's
    settled-knob early return."""
    t = np.broadcast_to(np.asarray(targets, np.float32),
                        state.smooth.current.shape)
    return state._replace(smooth=SmootherBank(current=jnp.asarray(t),
                                              target=jnp.asarray(t)))


def assert_tree_equal(a, b):
    for x, y in zip(jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_saturation_bypass_holds_state_exactly():
    """saturation.rs:230-232: bypassed blocks leave the oversampler history
    untouched — block-granular freeze makes that exact here."""
    engaged = [0.7, 0.5, 1.0]   # drive, warmth, mix
    bypass = [0.7, 0.5, 0.0]
    st = settled(sat_mod.init_state(SR), engaged)
    st, _ = sat_mod.process_block(st, jnp.asarray(sig(B, 0)), engaged,
                                  sample_rate=SR)
    frozen_ovs = st.ovs

    st_b = settled(st, bypass)
    for i in range(2):
        st_b, y = sat_mod.process_block(st_b, jnp.asarray(sig(B, 10 + i)),
                                        bypass, sample_rate=SR)
        np.testing.assert_array_equal(np.asarray(y), sig(B, 10 + i))
    assert_tree_equal(st_b.ovs, frozen_ovs)

    # re-engage renders are therefore bit-identical to the frozen twin
    x_re = jnp.asarray(sig(B, 99))
    st_run = settled(st_b, engaged)
    _, y_run = sat_mod.process_block(st_run, x_re, engaged, sample_rate=SR)
    _, y_frz = sat_mod.process_block(st_run._replace(ovs=frozen_ovs), x_re,
                                     engaged, sample_rate=SR)
    np.testing.assert_array_equal(np.asarray(y_run), np.asarray(y_frz))


def test_fbws_fast_path_bypass_holds_state_exactly():
    """feedback_waveshaper.rs:117-118: drive <= 1 is a frozen passthrough."""
    st = fbws_mod.FBShaperState.init((1,))
    run = lambda s, x, drive: fbws_mod.process_block(
        s, jnp.asarray(x), jnp.float32(drive), jnp.float32(0.0),
        jnp.float32(0.3), jnp.float32(1.0), SR, feedback_path=False)
    x0 = np.random.RandomState(2).randn(1, B).astype(np.float32) * 0.4
    st, _ = run(st, x0, 8.0)
    frozen = st

    st_b = st
    for i in range(2):
        x = np.random.RandomState(20 + i).randn(1, B).astype(np.float32) * 0.4
        st_b, y = run(st_b, x, 1.0)
        np.testing.assert_array_equal(np.asarray(y), x)  # exact passthrough
    assert_tree_equal(st_b, frozen)


def test_bass_clean_overdrive_holds_ovs_exactly():
    """bass.rs:846: the pre-filter waveshaper ticks only when od > 0.001 —
    clean blocks leave the bank's drive oversampler untouched."""
    from libgooey_tpu.instruments import bass as bass_mod

    coeff = float(np.asarray(smoothing_coeff(SR)))
    cfg = dataclasses.replace(bass_mod.BassConfig.acid(), overdrive=0.6)

    def blocks(state, od_norm, start, trig=False):
        t = np.asarray(cfg.as_array(), np.float32).copy()[None, :]
        t[0, bass_mod.PARAM_INDEX["overdrive"]] = od_norm
        bank = SmootherBank(current=jnp.asarray(t), target=jnp.asarray(t))
        state = state._replace(params=bank)
        off = np.zeros(1, np.int32) if trig else np.full(1, B, np.int32)
        vel = np.full(1, 1.0 if trig else 0.0, np.float32)
        return bass_mod.render_block(
            state, off, vel, np.int32(start), sample_rate=SR, block_size=B,
            smooth_coeff=coeff)

    st = bass_mod.init_state(1, cfg)
    st, _ = blocks(st, 0.6, 0, trig=True)
    frozen_ovs = st.ovs
    for i in range(2):
        st, _ = blocks(st, 0.0, (1 + i) * B)    # clean span
    assert_tree_equal(st.ovs, frozen_ovs)
    _, y_run = blocks(st, 0.6, 3 * B)
    _, y_frz = blocks(st._replace(ovs=frozen_ovs), 0.6, 3 * B)
    np.testing.assert_array_equal(np.asarray(y_run[0]), np.asarray(y_frz[0]))


def test_tilt_passthrough_holds_svf_exactly():
    """tilt_filter.rs:114-115: dead-center passthrough freezes the SVF."""
    engaged = [0.2, 0.6]     # knob in the LP region, resonant
    center = [0.5, 0.6]      # exact center: mix == 0 -> passthrough
    st = settled(tilt_mod.init_state(SR), engaged)
    st, _ = tilt_mod.process_block(st, jnp.asarray(sig(B, 5)), engaged,
                                   sample_rate=SR)
    frozen_svf = st.svf

    st_b = settled(st, center)
    for i in range(2):
        st_b, y = tilt_mod.process_block(st_b, jnp.asarray(sig(B, 30 + i)),
                                         center, sample_rate=SR)
        np.testing.assert_allclose(np.asarray(y), sig(B, 30 + i),
                                   rtol=0, atol=1e-7)
    assert_tree_equal(st_b.svf, frozen_svf)


def test_saturation_boundary_block_deviation_bounded():
    """The ONLY remaining freeze deviation: a block where the smoothed
    bypass condition crosses mid-block keeps the oversampler running to
    block end (the reference freezes at the crossing sample).  Bound it:
    the re-engage difference vs the reference-frozen twin is a transient
    confined to the boundary, decaying through the DC blocker's 0.995
    pole."""
    engaged = [0.7, 0.5, 1.0]
    st = settled(sat_mod.init_state(SR), engaged)
    st, _ = sat_mod.process_block(st, jnp.asarray(sig(B, 0)), engaged,
                                  sample_rate=SR)
    # mix target drops to 0: the trajectory crosses 1e-4 mid-block, so this
    # block is NOT all-bypassed and the history legitimately advances
    st_b, _ = sat_mod.process_block(st, jnp.asarray(sig(B, 1)), [0.7, 0.5, 0.0],
                                    sample_rate=SR)
    frozen_ovs = st.ovs     # reference: held from the crossing sample
    # settled bypass blocks follow: both histories now hold
    st_b = settled(st_b, [0.7, 0.5, 0.0])
    st_b, _ = sat_mod.process_block(st_b, jnp.asarray(sig(B, 2)),
                                    [0.7, 0.5, 0.0], sample_rate=SR)

    x_re = jnp.asarray(sig(B, 99))
    st_run = settled(st_b, engaged)
    s1_run, y_run = sat_mod.process_block(st_run, x_re, engaged, sample_rate=SR)
    s1_frz, y_frz = sat_mod.process_block(st_run._replace(ovs=frozen_ovs), x_re,
                                          engaged, sample_rate=SR)
    d = np.abs(np.asarray(y_run) - np.asarray(y_frz))
    # the differing history is one partial block of ~0.4-amplitude signal:
    # O(1) for the first few samples; the halfband ring is gone within
    # ~64 samples and the residual drains through the DC blocker's 0.995
    # pole (~1e-2 by mid-block, ~2e-3 within the next block)
    assert d.max() < 2.0, d.max()
    assert d[:, 256:].max() < 1e-2, d[:, 256:].max()
    x2 = jnp.asarray(sig(B, 100))
    _, y2_run = sat_mod.process_block(s1_run, x2, engaged, sample_rate=SR)
    _, y2_frz = sat_mod.process_block(s1_frz, x2, engaged, sample_rate=SR)
    d2 = np.abs(np.asarray(y2_run) - np.asarray(y2_frz))
    assert d2.max() < 2e-3, d2.max()
