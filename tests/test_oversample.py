"""Oversampler: alias reduction and passband integrity (the reference's
oversampler.rs:373-415 assertions: ≥20 dB alias reduction at 4x with < 1 dB
fundamental change, tanh drive 10 @ 10 kHz / 48 kHz)."""

import numpy as np
import jax.numpy as jnp

from libgooey_tpu.ops import oversample as ov

SR = 48000.0
N = 8192


def run(fn, x, mode):
    st = ov.OversamplerState.init(())
    outs = []
    for i in range(0, len(x), 512):
        st, y = ov.process(st, fn, jnp.asarray(x[i : i + 512]), mode)
        outs.append(np.asarray(y))
    return np.concatenate(outs)


def coherent(sig, freq):
    t = np.arange(2000, len(sig))
    ph = 2 * np.pi * freq * t / SR
    s = sig[2000:]
    return np.hypot(np.dot(s, np.cos(ph)), np.dot(s, np.sin(ph)))


def test_halfband_design_response():
    """Analytic stop-band of the stage-1 design exceeds 90 dB."""
    coefs = ov.STAGE1
    w = np.linspace(0.001, np.pi - 0.001, 2048)
    z2 = np.exp(-2j * w)

    def A(cs):
        r = np.ones_like(z2)
        for a in cs:
            r = r * (a + z2) / (1 + a * z2)
        return r

    H = 0.5 * (A(coefs[0::2]) + np.exp(-1j * w) * A(coefs[1::2]))
    sb = np.abs(H)[w > (0.5 + 2 * 0.04) * np.pi]
    pb = np.abs(H)[w < (0.5 - 2 * 0.04) * np.pi]
    assert 20 * np.log10(sb.max()) < -90.0
    assert abs(20 * np.log10(pb.min())) < 0.01


def test_passband_unity():
    t = np.arange(N)
    for f in [1000.0, 5000.0, 10000.0]:
        x = np.sin(2 * np.pi * f * t / SR).astype(np.float32)
        for mode in (2, 4):
            y = run(lambda v: v, x, mode)
            ratio = np.sqrt(np.mean(y[2000:] ** 2)) / np.sqrt(np.mean(x[2000:] ** 2))
            assert abs(ratio - 1.0) < 0.02, (f, mode, ratio)


def test_alias_reduction_tanh_drive10():
    t = np.arange(N)
    x = (np.sin(2 * np.pi * 10000 * t / SR) * 0.8).astype(np.float32)
    drive = lambda v: jnp.tanh(v * 10.0)
    base = run(drive, x, 1)
    os4 = run(drive, x, 4)
    # 3rd harmonic (30 kHz) folds to 18 kHz at the base rate
    alias_red = 20 * np.log10(
        coherent(base, 18000.0) / max(coherent(os4, 18000.0), 1e-12)
    )
    fund_change = 20 * np.log10(coherent(os4, 10000.0) / coherent(base, 10000.0))
    assert alias_red >= 20.0, alias_red
    assert abs(fund_change) < 1.0, fund_change


def test_block_boundary_continuity():
    """Split processing must equal one-shot processing (state carried)."""
    rs = np.random.RandomState(0)
    x = rs.uniform(-1, 1, 2048).astype(np.float32)
    whole_st = ov.OversamplerState.init(())
    _, whole = ov.process(whole_st, lambda v: jnp.tanh(v * 3), jnp.asarray(x), 4)
    split = run(lambda v: jnp.tanh(v * 3), x, 4)
    np.testing.assert_allclose(split, np.asarray(whole), atol=1e-5)


def test_4x_error_vs_16x_reference():
    """4x output must sit ≥10x closer to an (essentially alias-free) 16x
    reference than the base-rate output does (oversampler.rs:397-415)."""
    sr = 48_000.0
    n = 8192
    k = 1707  # coherent bin ≈ 10 kHz
    f0 = sr * k / n
    x = (0.9 * np.sin(2 * np.pi * f0 * np.arange(n) / sr)).astype(np.float32)
    fn = lambda v: jnp.tanh(10.0 * v)

    def run(mode):
        st = ov.OversamplerState.init(())
        _, y = ov.process(st, fn, jnp.asarray(x), mode)
        return np.asarray(y)

    # 16x reference: two extra octaves around the 4x chain, built from the
    # same half-band primitives (the top octaves reuse the wide-transition
    # stage design, which has a full octave of slack there)
    def run16():
        ups = [ov.HalfbandState.init(c) for c in
               (ov.STAGE1, ov.STAGE2, ov.STAGE2, ov.STAGE2)]
        downs = [ov.HalfbandState.init(c) for c in
                 (ov.STAGE2, ov.STAGE2, ov.STAGE2, ov.STAGE1)]
        coefs_up = (ov.STAGE1, ov.STAGE2, ov.STAGE2, ov.STAGE2)
        coefs_down = (ov.STAGE2, ov.STAGE2, ov.STAGE2, ov.STAGE1)
        sig = jnp.asarray(x)
        for i in range(4):
            ups[i], sig = ov.upsample2(ups[i], sig, coefs_up[i])
        sig = fn(sig)
        for i in range(4):
            downs[i], sig = ov.downsample2(downs[i], sig, coefs_down[i])
        return np.asarray(sig)

    ref = run16()
    win = np.hanning(4096)

    def spec(y):
        return np.abs(np.fft.rfft(y[4096:] * win))

    s_ref = spec(ref)
    err_base = np.linalg.norm(spec(run(1)) - s_ref)
    err_4x = np.linalg.norm(spec(run(4)) - s_ref)
    assert err_4x * 10.0 <= err_base, (err_4x, err_base)


def test_bank_toeplitz_path_matches_scan_path():
    """Wide voice banks route the allpass chains to the Toeplitz-matmul
    formulation (_allpass_chain_paired_mx); narrow batches keep the
    associative scans.  Same math, different association — the two must
    agree at float-noise level across state-threaded blocks."""
    import jax.numpy as jnp

    rs = np.random.RandomState(7)
    V, B = ov._MX_MIN_BATCH + 32, 512
    x = rs.randn(V, 2 * B).astype(np.float32) * 0.5
    fn = lambda v: jnp.tanh(3.0 * v)

    st = ov.OversamplerState.init((V,))
    bank = []
    for blk in range(2):
        st, y = ov.process(st, fn, jnp.asarray(x[:, blk * B:(blk + 1) * B]), 4)
        bank.append(np.asarray(y))
    bank = np.concatenate(bank, axis=1)

    narrow = np.empty_like(bank)
    for i in range(0, V, 8):  # batch 8 stays under the gate
        s = ov.OversamplerState.init((8,))
        for blk in range(2):
            s, y = ov.process(
                s, fn, jnp.asarray(x[i:i + 8, blk * B:(blk + 1) * B]), 4)
            narrow[i:i + 8, blk * B:(blk + 1) * B] = np.asarray(y)

    err = np.max(np.abs(bank - narrow))
    assert err < 1e-5, f"max path divergence {err}"


def test_lifted_chain_matches_toeplitz_and_scan():
    """The whole-chain lifted operator (MX_CHAIN_IMPL="lifted") must match
    the per-section Toeplitz matmuls AND the exact associative-scan path to
    f32 reassociation (~1e-6): same recurrence, exact f64-lifted constants,
    different association only."""
    import libgooey_tpu.ops.oversample as o

    rng = np.random.RandomState(0)
    V, B = 128, 512
    x = jnp.asarray(rng.randn(2, V, B).astype(np.float32) * 0.4)
    for stage in (o.STAGE1, o.STAGE2):
        pairs = o._pairs(stage)
        S = pairs.shape[0]
        y0 = jnp.asarray(rng.randn(2, V, S).astype(np.float32) * 0.1)
        x0 = jnp.asarray(rng.randn(2, V, S).astype(np.float32) * 0.1)
        prev = o.MX_CHAIN_IMPL
        try:
            o.MX_CHAIN_IMPL = "toeplitz"
            ref = [np.asarray(v) for v in
                   o._allpass_chain_paired(x, pairs, y0, x0)]
            o.MX_CHAIN_IMPL = "lifted"
            got = [np.asarray(v) for v in
                   o._allpass_chain_paired(x, pairs, y0, x0)]
        finally:
            o.MX_CHAIN_IMPL = prev
        for r, g in zip(ref, got):
            assert np.abs(r - g).max() < 2e-6
        # vs the exact scan path (small batch stays on scans)
        scan = [np.asarray(v) for v in o._allpass_chain_paired(
            x[:, :8], pairs, y0[:, :8], x0[:, :8])]
        for s, g in zip(scan, got):
            assert np.abs(s - g[:, :8]).max() < 2e-6
