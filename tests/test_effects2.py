"""Compressor, saturation, tilt, lowpass effect oracles and behavior."""

import numpy as np
import pytest

from libgooey_tpu.effects import compressor, lowpass, saturation, tilt
from oversample_oracle import OracleOversampler

SR = 44100.0
B = 512


def run_fx(mod, init_kw, x, targets, **kw):
    st = mod.init_state(SR, **init_kw)
    outs = []
    for i in range(0, x.shape[-1], B):
        st, y = mod.process_block(
            st, x[:, i : i + B], np.asarray(targets, np.float32), sample_rate=SR, **kw
        )
        outs.append(np.asarray(y))
    return np.concatenate(outs, axis=-1)


def test_compressor_oracle():
    """Blocked compressor vs per-sample transcription (settled params)."""
    rs = np.random.RandomState(0)
    n = 4096
    sig = (np.sin(2 * np.pi * 220 * np.arange(n) / SR) * 0.9).astype(np.float32)
    sig[: n // 4] *= 0.05
    x = np.stack([sig, sig])
    params = dict(threshold_db=-20.0, ratio=4.0, attack_ms=5.0, release_ms=80.0, mix=1.0)
    got = run_fx(compressor, params, x, list(params.values()))[0]

    env = 0.0
    gain = 1.0
    dcx = dcy = 0.0
    ovs = OracleOversampler(4)
    att = np.exp(-1.0 / (5.0 * 0.001 * SR))
    rel = np.exp(-1.0 / (80.0 * 0.001 * SR))
    out = np.zeros(n, np.float32)
    for i, xn in enumerate(sig):
        r = abs(xn)
        c = att if r > env else rel
        env = c * env + (1 - c) * r
        env_db = 20 * np.log10(env + 1e-20)
        over = env_db - (-20.0)
        slope = 1 - 1 / 4.0
        if over <= -3:
            gr = 0.0
        elif over >= 3:
            gr = over * slope
        else:
            gr = (over + 3) ** 2 / 12.0 * slope
        gl = 10 ** (-gr * 0.05)
        gain += 0.05 * (gl - gain)
        comp = xn * gain
        # tube atan through the 4x oversampler, always fed (compressor.rs:197)
        colored_os = ovs.process(comp, lambda v: np.arctan(v) * (2 / np.pi) * 1.1)
        colored = colored_os if gain < 0.99 else comp
        y = colored - dcx + 0.995 * dcy
        dcx, dcy = colored, y
        out[i] = y  # mix = 1
    err = np.max(np.abs(got - out))
    assert err < 2e-5, err  # measured 5.8e-7; well under the -80 dBFS bar


def test_compressor_reduces_dynamics():
    n = 8192
    t = np.arange(n)
    loud = np.sin(2 * np.pi * 200 * t / SR).astype(np.float32)
    x = np.stack([loud, loud])
    params = dict(threshold_db=-30.0, ratio=10.0, attack_ms=1.0, release_ms=50.0, mix=1.0)
    out = run_fx(compressor, params, x, list(params.values()))
    assert np.abs(out[0, 4000:]).max() < np.abs(loud[4000:]).max() * 0.6


def test_compressor_sidechain_ducks():
    n = 8192
    quiet = (np.sin(2 * np.pi * 400 * np.arange(n) / SR) * 0.1).astype(np.float32)
    duck = np.zeros(n, np.float32)
    duck[2000:4000] = 0.9
    x = np.stack([quiet, quiet])
    sc = np.stack([duck, duck])
    params = dict(threshold_db=-30.0, ratio=10.0, attack_ms=1.0, release_ms=30.0, mix=1.0)
    st = compressor.init_state(SR, **params)
    outs = []
    for i in range(0, n, B):
        st, y = compressor.process_block(
            st, x[:, i : i + B], np.asarray(list(params.values()), np.float32),
            sample_rate=SR, sidechain=sc[:, i : i + B],
        )
        outs.append(np.asarray(y))
    out = np.concatenate(outs, axis=-1)[0]
    rms = lambda seg: np.sqrt(np.mean(seg**2))
    assert rms(out[2500:3800]) < 0.5 * rms(out[200:1800])


def test_saturation_oracle_and_harmonics():
    n = 8192
    x0 = (np.sin(2 * np.pi * 441 * np.arange(n) / SR) * 0.8).astype(np.float32)
    x = np.stack([x0, x0])
    got = run_fx(saturation, dict(drive=0.5, warmth=0.5, mix=1.0), x, [0.5, 0.5, 1.0])[0]
    drive, bias = 1 + 0.5 * 7, 0.5 * 0.4
    dcx = dcy = 0.0
    ovs = OracleOversampler(4)

    def sat_fn(v):
        driven = v * drive
        biased = driven + bias * abs(driven)
        soft = np.arctan(biased) * 2 / np.pi
        return soft + soft**2 * np.sign(soft) * 0.15 * bias

    want = np.zeros(n, np.float32)
    for i, xn in enumerate(x0):
        sat = ovs.process(xn, sat_fn)  # 4x oversampled curve
        y = sat - dcx + 0.995 * dcy
        dcx, dcy = sat, y
        want[i] = y
    assert np.max(np.abs(got - want)) < 2e-5  # measured 1.3e-6
    # asymmetric bias generates even harmonics
    sp = np.abs(np.fft.rfft(got[2048:6144] * np.hanning(4096)))
    f = np.fft.rfftfreq(4096, 1 / SR)
    h2 = sp[np.argmin(np.abs(f - 882))]
    assert h2 > 0.005 * sp.max()


def test_tilt_lp_and_hp_regions():
    n = 16384
    t = np.arange(n)
    lo = np.sin(2 * np.pi * 100 * t / SR).astype(np.float32)
    hi = np.sin(2 * np.pi * 8000 * t / SR).astype(np.float32)
    x = np.stack([lo + hi, lo + hi])
    rms = lambda v: np.sqrt(np.mean(v[n // 2 :] ** 2))

    dark = run_fx(tilt, dict(), x, [0.0, 0.3])[0]   # full LP at 80 Hz
    bright = run_fx(tilt, dict(), x, [1.0, 0.3])[0]  # full HP at 8 kHz
    center = run_fx(tilt, dict(), x, [0.5, 0.3])[0]

    def band(v, f0):
        ph = 2 * np.pi * f0 * t / SR
        return np.hypot(np.dot(v, np.cos(ph)), np.dot(v, np.sin(ph)))

    assert band(dark, 8000) < 0.2 * band(center, 8000)
    assert band(bright, 100) < 0.2 * band(center, 100)
    np.testing.assert_allclose(center, (lo + hi), atol=2e-3)  # passthrough


def test_lowpass_oracle():
    rs = np.random.RandomState(3)
    n = 2048
    x0 = rs.uniform(-0.5, 0.5, n).astype(np.float32)
    x = np.stack([x0, x0])
    got = run_fx(lowpass, dict(cutoff=2000.0, resonance=0.5), x, [2000.0, 0.5])[0]
    g = min(max(1 - np.exp(-2 * np.pi * 2000.0 / SR), 0.0), 0.9)
    fr = min(2000.0 / 5000.0, 1.0)
    fb = 0.5 * (1 - fr * fr * 0.7) * 3.5
    s1 = s2 = 0.0
    want = np.zeros(n, np.float32)
    for i, xn in enumerate(x0):
        infb = xn - np.tanh(s2 * fb) * min(fb, 1.0)
        s1 = s1 + g * (infb - s1)
        s2 = s2 + g * (s1 - s2)
        want[i] = np.tanh(s2)
    assert np.max(np.abs(got - want)) < 1e-4


def test_lowpass_attenuates_highs():
    n = 16384
    t = np.arange(n)
    hi = np.sin(2 * np.pi * 10000 * t / SR).astype(np.float32)
    x = np.stack([hi, hi])
    out = run_fx(lowpass, dict(cutoff=500.0, resonance=0.0), x, [500.0, 0.0])[0]
    assert np.sqrt(np.mean(out[8000:] ** 2)) < 0.05


def test_saturation_wired_oversampling_reduces_aliasing():
    """The block path's built-in 4x oversampling must beat engine-rate
    saturation on alias energy (oversampler.rs:373-394's assertion, applied
    to the wired-in effect)."""
    n = 8192
    f0 = 10_000.5 * (SR / 48000.0)  # high fundamental, non-coherent
    x0 = (np.sin(2 * np.pi * f0 * np.arange(n) / SR) * 0.9).astype(np.float32)
    x = np.stack([x0, x0])
    args = (dict(drive=1.0, warmth=0.0, mix=1.0), x, [1.0, 0.0, 1.0])

    def alias_energy(sig):
        sp = np.abs(np.fft.rfft(sig[4096:] * np.hanning(4096)))
        f = np.fft.rfftfreq(4096, 1 / SR)
        harmonics = [f0 * k for k in (1, 3, 5, 7, 9)]
        mask = np.ones_like(sp, bool)
        for h in harmonics:
            mask &= np.abs(f - h) > 200.0
        mask &= f > 500.0
        return np.sqrt(np.sum(sp[mask] ** 2)), sp[np.argmin(np.abs(f - f0))]

    base = run_fx(saturation, *args, os_mode=1)[0]
    over = run_fx(saturation, *args)[0]  # default os_mode=4
    alias_base, fund_base = alias_energy(base)
    alias_over, fund_over = alias_energy(over)
    reduction_db = 20 * np.log10(alias_base / alias_over)
    assert reduction_db > 20.0, reduction_db
    fund_change_db = abs(20 * np.log10(fund_over / fund_base))
    assert fund_change_db < 1.0, fund_change_db


def _bus_entry(effect_id, state, x, targets, flag=False):
    from libgooey_tpu.mixer import chain

    outs = []
    for i in range(0, x.shape[-1], B):
        state, y = chain.process_entry(
            effect_id, state, x[:, i:i + B], np.asarray(targets, np.float32),
            sample_rate=SR, pingpong=flag)
        outs.append(np.asarray(y))
    return np.concatenate(outs, axis=-1)


def test_bus_waveshaper_4x_oracle():
    """The bus waveshaper entry through the 4x oversampler vs a per-sample
    transcription (waveshaper.rs:59-68 curve, oversampler.rs chain)."""
    from libgooey_tpu.mixer import chain
    from libgooey_tpu.ops.oversample import OversamplerState

    n = 4 * B
    x0 = (np.sin(2 * np.pi * 441 * np.arange(n) / SR) * 0.8).astype(np.float32)
    drive, mix = 3.0, 0.7
    got = _bus_entry(chain.EFFECT_WAVESHAPER, OversamplerState.init((2,)),
                     np.stack([x0, x0]), [drive, mix])[0]
    comp = np.tanh(0.5) / np.tanh(0.5 * np.float32(drive))
    ovs = OracleOversampler(4)
    want = np.zeros(n, np.float32)
    for i, xn in enumerate(x0):
        wet = ovs.process(xn, lambda v: np.tanh(v * np.float32(drive)) * comp)
        want[i] = xn * (1.0 - mix) + wet * mix
    assert np.max(np.abs(got - want)) < 2e-5


def test_bus_feedback_waveshaper_4x_oracle():
    """The bus feedback waveshaper's zero-feedback path (4x tanh, envelope
    follower, makeup gain, DC blocker) vs a per-sample transcription of
    feedback_waveshaper.rs."""
    from libgooey_tpu.effects import feedback_waveshaper as fbws
    from libgooey_tpu.mixer import chain

    n = 4 * B
    t = np.arange(n) / SR
    x0 = (np.sin(2 * np.pi * 330 * t) * np.linspace(0.9, 0.1, n)
          ).astype(np.float32)
    drive, mix = 4.0, 0.6
    got = _bus_entry(chain.EFFECT_FEEDBACK_WAVESHAPER,
                     fbws.FBShaperState.init((2,)), np.stack([x0, x0]),
                     [drive, 0.0, 2000.0, mix], flag=True)[0]
    att, rel = fbws.env_coeffs(SR)
    ovs = OracleOversampler(4)
    env = dcx = dcy = 0.0
    want = np.zeros(n, np.float32)
    for i, xn in enumerate(x0):
        shaped = ovs.process(np.float32(drive) * xn, np.tanh)
        r = abs(float(xn))
        c = att if r > env else rel
        env = env + (1.0 - c) * (r - env)
        ref = max(env, fbws.ENV_FLOOR)
        comp = min(np.tanh(ref) / max(abs(np.tanh(ref * drive)), 1e-6),
                   fbws.MAX_COMP_GAIN)
        y = shaped * comp - dcx + fbws.DC_COEFF * dcy
        dcx, dcy = shaped * comp, y
        want[i] = xn * (1.0 - mix) + y * mix
    assert np.max(np.abs(got - want)) < 2e-5


@pytest.mark.parametrize("knob", [0.2, 0.8], ids=["lp_region", "hp_region"])
def test_bus_tilt_oracle(knob):
    """The bus tilt filter at a settled knob vs a per-sample TPT SVF
    (tilt_filter.rs region maps, state_variable_tpt.rs:42-68)."""
    rs = np.random.RandomState(4)
    n = 4 * B
    x0 = rs.uniform(-0.8, 0.8, n).astype(np.float32)
    res = 0.6
    got = run_fx(tilt, dict(cutoff=knob, resonance=res), np.stack([x0, x0]),
                 [knob, res])[0]
    f32 = np.float32
    if knob < 0.5:
        mix = f32(1.0 - knob * 2.0)
        freq = tilt.LP_FREQ[0] * np.exp(np.log(tilt.LP_FREQ[1] / tilt.LP_FREQ[0])
                                        * (knob * 2.0))
    else:
        mix = f32((knob - 0.5) * 2.0)
        freq = tilt.HP_FREQ[0] * np.exp(np.log(tilt.HP_FREQ[1] / tilt.HP_FREQ[0])
                                        * ((knob - 0.5) * 2.0))
    q = 0.5 + res * 8.0
    g = f32(np.tan(np.pi * np.clip(freq, 20.0, SR * 0.45) / SR))
    r = f32(1.0 / max(q, 0.5))
    h = f32(1.0 / (1.0 + r * g + g * g))
    ic1 = ic2 = f32(0.0)
    want = np.zeros(n, np.float32)
    for i, xn in enumerate(x0):
        v1 = f32((g * (xn - ic2) + ic1) * h)
        v2 = f32(ic2 + g * v1)
        ic1, ic2 = f32(2 * v1 - ic1), f32(2 * v2 - ic2)
        wet = v2 if knob < 0.5 else f32(xn - (r * v1 + v2))
        want[i] = xn * (1.0 - mix) + wet * mix
    assert np.max(np.abs(got - want)) < 1e-4
