"""Granulator + SamplerRack: determinism, pool behavior, playback oracles."""

import numpy as np

from libgooey_tpu.core.smoother import smoothing_coeff
from libgooey_tpu.instruments import granulator as gr
from libgooey_tpu.instruments import sampler as sm

SR = 44100.0
B = 512


def run_granulator(cfg, buffer, n, seed=42, velocity=1.0):
    host = gr.GranulatorHost(SR, buffer, SR, cfg, seed=seed)
    state = gr.init_state(buffer, SR, cfg)
    coeff = smoothing_coeff(SR)
    host.trigger(0.0, velocity)
    outs = []
    for start in range(0, n, B):
        ev = host.collect_events(start, B)
        state, y = gr.render_block(
            state, ev, np.int32(start), sample_rate=SR, block_size=B,
            smooth_coeff=coeff,
        )
        outs.append(np.asarray(y))
    return np.concatenate(outs)[:n]


def test_granulator_produces_grains_and_decays():
    rs = np.random.RandomState(0)
    buf = rs.uniform(-0.5, 0.5, 44100).astype(np.float32)
    cfg = gr.GranulatorConfig(density=0.5, cloud_duration=0.05, grain_length=0.2)
    out = run_granulator(cfg, buf, 44100)
    assert np.all(np.isfinite(out))
    assert np.abs(out[:20000]).max() > 0.01
    # cloud 50+0.05*7950 ≈ 448 ms; grains ≤ ~0.2^2*3+0.005 s → silent by 1 s
    assert np.abs(out[-2000:]).max() < 1e-6


def test_granulator_seeded_determinism():
    """set_seed → identical grain cloud (granulator.rs:833-867 contract)."""
    rs = np.random.RandomState(1)
    buf = rs.uniform(-0.5, 0.5, 22050).astype(np.float32)
    cfg = gr.GranulatorConfig(density=0.6, random_timing=0.5, random_amp=0.5,
                              spray=0.3)
    a = run_granulator(cfg, buf, 22050, seed=7)
    b = run_granulator(cfg, buf, 22050, seed=7)
    c = run_granulator(cfg, buf, 22050, seed=8)
    np.testing.assert_array_equal(a, b)
    assert np.abs(a - c).max() > 1e-6


def test_granulator_density_scales_grain_count():
    rs = np.random.RandomState(2)
    buf = rs.uniform(-0.5, 0.5, 22050).astype(np.float32)
    sparse_host = gr.GranulatorHost(SR, buf, SR, gr.GranulatorConfig(density=0.1))
    dense_host = gr.GranulatorHost(SR, buf, SR, gr.GranulatorConfig(density=0.9))
    for host in (sparse_host, dense_host):
        host.trigger(0.0, 1.0)
    n_sparse = n_dense = 0
    for start in range(0, 22050, B):
        n_sparse += int((np.asarray(sparse_host.collect_events(start, B).slot) >= 0).sum())
        n_dense += int((np.asarray(dense_host.collect_events(start, B).slot) >= 0).sum())
    assert n_dense > 3 * max(n_sparse, 1)


def test_granulator_pitch_changes_read_speed():
    # pure tone buffer: pitch ratio shifts the perceived frequency
    t = np.arange(44100)
    buf = np.sin(2 * np.pi * 440 * t / SR).astype(np.float32)
    up = run_granulator(
        gr.GranulatorConfig(pitch=1.0, density=0.3, grain_length=0.5,
                            cloud_duration=0.2, spray=0.0), buf, 22050)
    down = run_granulator(
        gr.GranulatorConfig(pitch=0.0, density=0.3, grain_length=0.5,
                            cloud_duration=0.2, spray=0.0), buf, 22050)

    def centroid(x):
        sp = np.abs(np.fft.rfft(x)) ** 2
        f = np.fft.rfftfreq(len(x), 1 / SR)
        return (sp * f).sum() / (sp.sum() + 1e-12)

    assert centroid(up) > 2 * centroid(down)


# --- sampler -------------------------------------------------------------------


def run_rack(host: sm.SamplerRackHost, n):
    state = sm.init_state(arena_frames=1 << 16)
    outs = []
    for start in range(0, n, B):
        ev = host.collect_events(start, B)
        if host.arena_dirty:
            state = state._replace(arena=np.asarray(host.arena))
            host.arena_dirty = False
        state, y = sm.render_block(
            state, ev, np.int32(start), sample_rate=SR, block_size=B
        )
        outs.append(np.asarray(y))
    return np.concatenate(outs, axis=-1)[:, :n]


def test_sampler_plays_ramp_slot_exactly():
    host = sm.SamplerRackHost(SR, 120.0, arena_frames=1 << 16)
    ramp = (np.arange(1000) / 1000.0).astype(np.float32)
    host.set_buffer(0, ramp, SR)
    host.trigger(0, 1.0, offset=10)
    out = run_rack(host, 2048)
    # same-rate playback: out[10 + i] == ramp[i] * edge_fade(i)
    i = np.arange(1000)
    fade = np.minimum(np.minimum(i / 32.0, np.maximum((1000 - i) / 32.0, 0)), 1.0)
    want = ramp * fade.astype(np.float32)
    np.testing.assert_allclose(out[0, 10:1010], want, atol=1e-5)
    assert np.abs(out[:, 1100:]).max() == 0.0  # one-shot, no tail


def test_sampler_resamples_by_buffer_rate():
    host = sm.SamplerRackHost(SR, 120.0, arena_frames=1 << 16)
    t = np.arange(4410)
    tone = np.sin(2 * np.pi * 441 * t / SR).astype(np.float32)
    host.set_buffer(0, tone, SR * 2)  # double-rate buffer → plays at 2x speed
    host.trigger(0, 1.0)
    out = run_rack(host, 4096)[0]
    sp = np.abs(np.fft.rfft(out[:2048] * np.hanning(2048)))
    f = np.fft.rfftfreq(2048, 1 / SR)
    assert abs(f[np.argmax(sp)] - 882) < 40


def test_sampler_voice_stealing_oldest():
    host = sm.SamplerRackHost(SR, 120.0, arena_frames=1 << 16)
    host.set_buffer(0, np.ones(44100, np.float32), SR)  # long slot
    for _ in range(sm.VOICES + 4):
        host.trigger(0, 1.0)
    ev = host.collect_events(0, B)
    voices = np.asarray(ev.voice)
    assert (voices >= 0).sum() == sm.MAX_STARTS_PER_BLOCK  # capped per block
    assert len(set(voices[voices >= 0].tolist())) == sm.MAX_STARTS_PER_BLOCK


def test_sampler_sequencer_selects_slot():
    host = sm.SamplerRackHost(SR, 480.0, arena_frames=1 << 16)
    host.set_buffer(0, np.full(64, 0.5, np.float32), SR)
    host.set_buffer(3, np.full(64, -0.5, np.float32), SR)
    host.set_step(0, True, 0, 1.0)
    host.set_step(1, True, 3, 1.0)
    host.schedule_start(0.0)
    host.activate_start_if_due(0.0)
    out = run_rack(host, 8192)[0]
    # 480 BPM → step = 5512.5/4 ≈ 1378 samples; step 0 positive, step 1 negative
    assert out[40] > 0.1
    assert out[1378 + 40] < -0.1
