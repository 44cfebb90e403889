"""Scan toolkit vs per-sample oracles."""

import jax.numpy as jnp
import numpy as np

from libgooey_tpu.ops import scan as gscan


def test_linrec1_matches_sequential():
    rs = np.random.RandomState(0)
    a = rs.uniform(0.5, 0.999, size=(3, 64)).astype(np.float32)
    b = rs.uniform(-1, 1, size=(3, 64)).astype(np.float32)
    y0 = rs.uniform(-1, 1, size=(3,)).astype(np.float32)

    y = np.asarray(gscan.linrec1(a, b, y0))

    ref = np.zeros_like(b)
    prev = y0.copy()
    for n in range(64):
        prev = a[:, n] * prev + b[:, n]
        ref[:, n] = prev
    np.testing.assert_allclose(y, ref, rtol=1e-5, atol=1e-6)


def test_onepole_matches_smoother_tick():
    # reference smoother: current += coeff * (target - current)
    coeff = 0.0066225
    x = np.full((1, 128), 0.8, np.float32)
    y = np.asarray(gscan.onepole(coeff, x, np.zeros(1, np.float32)))[0]
    cur = 0.0
    for n in range(128):
        cur += coeff * (0.8 - cur)
        assert abs(y[n] - cur) < 1e-5


def test_onepole_const_closed_form():
    coeff = 0.01
    y0 = np.array([0.0, 1.0], np.float32)
    x = np.array([1.0, 1.0], np.float32)
    y = np.asarray(gscan.onepole_const(coeff, x, y0, 32))
    y_scan = np.asarray(gscan.onepole(coeff, np.broadcast_to(x[:, None], (2, 32)), y0))
    np.testing.assert_allclose(y, y_scan, atol=1e-5)


def test_linrec2_matches_sequential():
    rs = np.random.RandomState(1)
    B = 48
    mats = rs.uniform(-0.9, 0.9, size=(B, 2, 2)).astype(np.float32) * 0.7
    vecs = rs.uniform(-1, 1, size=(B, 2)).astype(np.float32)
    s0 = rs.uniform(-1, 1, size=(2,)).astype(np.float32)

    s1, s2 = gscan.linrec2(
        mats[:, 0, 0], mats[:, 0, 1], mats[:, 1, 0], mats[:, 1, 1],
        vecs[:, 0], vecs[:, 1],
        (jnp.asarray(s0[0]), jnp.asarray(s0[1])),
    )
    s1, s2 = np.asarray(s1), np.asarray(s2)

    s = s0.copy()
    for n in range(B):
        s = mats[n] @ s + vecs[n]
        assert abs(s1[n] - s[0]) < 1e-4
        assert abs(s2[n] - s[1]) < 1e-4


def test_cumsum_reset():
    x = np.ones((1, 10), np.float32)
    reset = np.zeros((1, 10), bool)
    reset[0, 4] = True
    y = np.asarray(
        gscan.cumsum_reset(x, reset, np.zeros((1, 10), np.float32), np.asarray([100.0], np.float32))
    )[0]
    np.testing.assert_allclose(y[:4], [101, 102, 103, 104])
    np.testing.assert_allclose(y[4:], [1, 2, 3, 4, 5, 6])


def test_nonlinear_scan_shapes():
    def step(carry, x):
        carry = np.tanh(1.0) * 0 + carry * 0.5 + x
        return carry, carry * 2.0

    state = jnp.zeros(3)
    xs = jnp.ones((3, 16))
    new_state, ys = gscan.nonlinear_scan(step, state, xs)
    assert ys.shape == (3, 16)
    assert new_state.shape == (3,)


def test_phase_cumsum_reset_exactness_and_semantics():
    """phase_cumsum_reset matches the f64 serial recurrence to ~1e-7 cycles
    even at high pitch (a raw tree cumsum rounds at eps(inc*B) per level),
    and honors carry + mid-block resets."""
    import jax.numpy as jnp

    rs = np.random.RandomState(3)
    B = 512
    for freq_hz in (55.0, 3500.0, 9900.0):
        inc = np.full((1, B), freq_hz / 44100.0, np.float32)
        inc += (rs.randn(1, B) * 1e-6).astype(np.float32)  # smoothed wiggle
        reset = np.zeros((1, B), np.float32)
        reset[0, 137] = 1.0
        carry = np.float32([0.7321])
        got = np.asarray(gscan.phase_cumsum_reset(
            jnp.asarray(inc), jnp.asarray(reset), jnp.asarray(carry)))
        y = float(carry[0])
        tru = np.empty(B)
        for n in range(B):
            y = float(inc[0, n]) + (0.0 if reset[0, n] else y)
            tru[n] = y % 1.0
        d = np.abs(got[0] - tru) % 1.0
        cyc = np.minimum(d, 1.0 - d).max()
        assert cyc < 5e-7, (freq_hz, cyc)
        assert np.all((got >= 0.0) & (got < 1.0))
