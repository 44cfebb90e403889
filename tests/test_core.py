"""Core math: pan law, envelopes, max_curve, smoother, rng — reference-derived
assertions (see SURVEY.md §4: pan power constancy frame.rs:135-141, smoother
convergence smoother.rs:203-219, curve endpoints max_curve.rs:195-209)."""

import numpy as np

from libgooey_tpu.core import dsp, envelope, max_curve, rng, smoother


def test_pan_equal_power():
    x = 0.6
    for pan in [0.0, 0.25, 0.5, 0.75, 1.0]:
        s = np.asarray(dsp.panned(np.float32(x), np.float32(pan)))
        assert abs(s[0] ** 2 + s[1] ** 2 - x * x) < 1e-5
    center = np.asarray(dsp.pan_gains(np.float32(0.5)))
    assert abs(center[0] - np.sqrt(0.5)) < 1e-6  # −3 dB center


def test_pan_extremes_and_clamp():
    l = np.asarray(dsp.panned(np.float32(0.8), np.float32(0.0)))
    assert abs(l[0] - 0.8) < 1e-6 and abs(l[1]) < 1e-6
    clamped = np.asarray(dsp.panned(np.float32(0.5), np.float32(-1.0)))
    np.testing.assert_allclose(clamped, np.asarray(dsp.panned(np.float32(0.5), np.float32(0.0))))


def test_tuning_to_multiplier():
    assert abs(float(dsp.tuning_to_multiplier(0.5)) - 1.0) < 1e-6
    assert abs(float(dsp.tuning_to_multiplier(0.0)) - 0.5) < 1e-6
    assert abs(float(dsp.tuning_to_multiplier(1.0)) - 2.0) < 1e-6


def test_raised_sine_window_hann():
    # shape 2 reproduces a Hann window exactly (utils/mod.rs:39-44)
    ph = np.linspace(0, 1, 33).astype(np.float32)
    w = np.asarray(dsp.raised_sine_window(ph, 2.0))
    hann = 0.5 - 0.5 * np.cos(2 * np.pi * ph)
    np.testing.assert_allclose(w, hann, atol=1e-5)


def test_adsr_phases():
    env = envelope.adsr(0.01, 0.1, 0.0, 0.02)
    # attack ramp
    assert abs(float(envelope.amplitude(env, np.float32(0.005))) - 0.5) < 1e-5
    # peak at attack end
    assert abs(float(envelope.amplitude(env, np.float32(0.01))) - 1.0) < 1e-4
    # mid decay (linear): 1 - progress
    a = float(envelope.amplitude(env, np.float32(0.06)))
    assert abs(a - 0.5) < 1e-4
    # sustain 0 → silent after attack+decay
    assert float(envelope.amplitude(env, np.float32(0.2))) == 0.0
    # not yet triggered
    assert float(envelope.amplitude(env, np.float32(-1.0))) == 0.0


def test_adsr_curves():
    env = envelope.adsr(0.01, 0.1, 0.0, 0.02, decay_curve=2.0)
    # decay progress 0.5 with curve 2 → 1 - 0.25 = 0.75
    a = float(envelope.amplitude(env, np.float32(0.06)))
    assert abs(a - 0.75) < 1e-4


def test_adsr_sustain_and_release():
    env = envelope.adsr(0.01, 0.1, 0.7, 0.1)
    assert abs(float(envelope.amplitude(env, np.float32(0.5))) - 0.7) < 1e-5
    # manual release from sustain: ramp to zero over release
    a = float(
        envelope.amplitude(env, np.float32(0.55), release_elapsed=np.float32(0.05))
    )
    assert abs(a - 0.35) < 1e-5
    a = float(
        envelope.amplitude(env, np.float32(0.7), release_elapsed=np.float32(0.2))
    )
    assert a == 0.0


def test_max_curve_endpoints_and_linear():
    for c in [-0.9, -0.5, 0.0, 0.5, 0.9]:
        assert abs(float(max_curve.max_curve(0.0, c))) < 1e-3
        assert abs(float(max_curve.max_curve(1.0, c)) - 1.0) < 1e-3
    assert abs(float(max_curve.max_curve(0.5, 0.0)) - 0.5) < 1e-3


def test_max_curve_oracle():
    """Vectorized max_curve vs a direct transcription of max_curve.rs:21-48."""

    def oracle(progress, curve):
        progress = min(max(progress, 0.0), 1.0)
        if abs(curve) < 1e-6:
            return progress
        if curve < 0.0:
            return 1.0 - oracle(1.0 - progress, -curve)
        hp = ((abs(curve) + 1e-20) * 1.2) ** 0.41 * 0.91
        fp = hp / (1.0 - hp)
        if abs(fp) < 1e-6:
            return progress
        return np.expm1(fp * progress) / np.expm1(fp)

    for c in [-0.83, -0.3, 0.2, 0.8]:
        for p in np.linspace(0, 1, 17):
            got = float(max_curve.max_curve(np.float32(p), np.float32(c)))
            want = oracle(float(p), c)
            assert abs(got - want) < 1e-4, (p, c, got, want)


def test_max_curve_segments():
    # hihat2-style: [(1, attack_ms, -0.3), (0, decay_ms, -0.8)]
    targets = (1.0, 0.0)
    durations = (0.001, 0.05)
    curves = (-0.3, -0.8)
    t = np.array([-0.1, 0.0005, 0.001, 0.02, 0.051, 0.2], np.float32)
    v = np.asarray(max_curve.segments_value(t, 0.0, targets, durations, curves))
    assert v[0] == 0.0              # before trigger
    assert 0.0 < v[1] < 1.0         # mid attack
    assert abs(v[2] - 1.0) < 1e-3   # attack done
    assert 0.0 < v[3] < 1.0         # mid decay
    assert v[4] < 0.05              # decay done
    assert abs(v[5]) < 1e-6         # holds final value


def test_smoother_block_matches_tick_loop():
    sr = 44100.0
    coeff = smoother.smoothing_coeff(sr, 10.0)
    bank = smoother.SmootherBank.init(np.zeros(1, np.float32)).with_targets(
        np.ones(1, np.float32)
    )
    _, traj = smoother.smooth_block(bank, coeff, 4410)
    traj = np.asarray(traj)[0]
    cur = 0.0
    for n in range(4410):
        cur += coeff * (1.0 - cur)
        if abs(cur - 1.0) < 1e-4:
            cur = 1.0
        assert abs(traj[n] - cur) < 2e-4, n
    # reaches and settles at the target (smoother.rs test_smoother_reaches_target)
    assert traj[-1] == 1.0


def test_smoother_settles_within_1e4():
    sr = 44100.0
    coeff = smoother.smoothing_coeff(sr)
    bank = smoother.SmootherBank.init(np.zeros(3, np.float32)).with_targets(
        np.array([1.0, -0.5, 0.25], np.float32)
    )
    bank2, traj = smoother.smooth_block(bank, coeff, 8192)
    np.testing.assert_array_equal(
        np.asarray(bank2.current), np.array([1.0, -0.5, 0.25], np.float32)
    )


def test_smooth_advance_matches_smooth_block():
    rs = np.random.RandomState(7)
    cur = rs.randn(64).astype(np.float32)
    tgt = rs.randn(64).astype(np.float32)
    tgt[:8] = cur[:8] + 4e-5  # settle-snap lanes
    bank = smoother.SmootherBank(np.asarray(cur), np.asarray(tgt))
    coeff = 0.0015059
    ref, _ = smoother.smooth_block(bank, coeff, 512)
    got = smoother.smooth_advance(bank, coeff, 512)
    np.testing.assert_array_equal(np.asarray(got.current), np.asarray(ref.current))
    np.testing.assert_array_equal(np.asarray(got.target), np.asarray(ref.target))


def test_white_noise_deterministic_and_bounded():
    n = np.arange(10_000)
    w = np.asarray(rng.white(n.astype(np.uint32)))
    w2 = np.asarray(rng.white(n.astype(np.uint32)))
    np.testing.assert_array_equal(w, w2)
    assert np.all(np.abs(w) <= 1.0)
    assert abs(w.mean()) < 0.02
    assert 0.25 < w.var() < 0.42  # uniform variance ~1/3


def test_xorshift64star_reference_vectors():
    """xorshift64* must match the Rust algorithm exactly (pink_noise.rs:67-79)."""
    g = rng.XorShift64Star(0x123456789ABCDEF0)
    x = 0x123456789ABCDEF0
    for _ in range(10):
        x ^= x >> 12
        x = (x ^ (x << 25)) & 0xFFFFFFFFFFFFFFFF
        x ^= x >> 27
        want = (x * 0x2545F4914F6CDD1D) & 0xFFFFFFFFFFFFFFFF
        assert g.next_u64() == want
