"""Planned-span product renderer vs the per-block path.

`GooeyEngine.render(frames)` with frames >= 2 blocks dispatches ONE scanned
device program (`gooey._span_render`) whose per-block step is the device
half of `_render_one_block`, with the host half pre-planned
(`_plan_host_block`).  These tests pin the two paths sample-for-sample
across every host-interaction class the reference FFI pipeline supports
(ffi.rs:1043-1380): sequencer triggers with swing, per-step blend snaps,
per-step note overrides with param save/restore, manual triggers, LFO
routes, performance-clip replay, sampler racks, the granulator, loop
channels under the clip grid, strip gating, the sidechained compressor,
and the global FX chain.  The span is the realtime lookahead story:
one dispatch per K blocks amortizes the dispatch floor K×
(engine_output.rs:305-311 budget).
"""

import numpy as np
import pytest

from libgooey_tpu.gooey import GooeyEngine
from libgooey_tpu.mixer import chain as chain_mod

SR = 44100.0
B = 512

#: scan-vs-sequential dispatch reassociation bar (same computation, one
#: program vs many; saturation/delay chains amplify f32 rounding slightly)
TOL = 1e-4


def _pair(setup):
    ga, gb = GooeyEngine(SR, B), GooeyEngine(SR, B)
    gb.span_rendering = False
    for g in (ga, gb):
        setup(g)
    return ga, gb


def _compare(ga, gb, frames, tol=TOL):
    a, b = ga.render(frames), gb.render(frames)
    assert ga.error is None, ga.error
    assert gb.error is None, gb.error
    err = float(np.abs(a - b).max())
    assert err < tol, err
    return a


@pytest.mark.slow
def test_span_sequencers_swing_gating_fx():
    def setup(g):
        for ch in range(4):
            g.sequencers[ch].set_pattern_string("x.x.x.x.x.x.x.x.")
            g.sequencers[ch].set_swing(0.6)
            g.sequencers[ch].start()
        g.strip_pan[:] = [0.2, 0.4, 0.6, 0.8, 0.5]
        g.strip_mute[3] = True
        g.strip_solo[1] = True
        for eid in (chain_mod.EFFECT_SATURATION, chain_mod.EFFECT_DELAY,
                    chain_mod.EFFECT_REVERB):
            g.set_effect_enabled(eid, True)
        g.trigger_channel(1, 0.9)

    ga, gb = _pair(setup)
    _compare(ga, gb, 8 * B)
    # state must carry across span boundaries and into the per-block path
    _compare(ga, gb, 3 * B)
    ga.span_rendering = False
    _compare(ga, gb, 2 * B)


def test_span_blend_and_note_steps():
    """Per-step blend snaps + per-step MIDI note overrides (param-0
    save/restore) arrive mid-span as staged target/snap events."""
    from libgooey_tpu.core.blendable import PresetBlender
    from libgooey_tpu.instruments import kick as kick_mod

    def setup(g):
        blender = PresetBlender(
            kick_mod.KickConfig.tight(), kick_mod.KickConfig.punch_preset(),
            kick_mod.KickConfig.loose(), kick_mod.KickConfig.dirt(),
        )
        g.set_blender(0, blender)
        seq = g.sequencers[0]
        seq.set_pattern_string("x.x.x.x.x.x.x.x.")
        seq.set_step_blend(2, 0.9, 0.1)
        seq.set_step_blend(6, 0.1, 0.9)
        seq.start()
        seq2 = g.sequencers[1]
        seq2.set_pattern_string("x...x...x...x...")
        seq2.set_step_note(0, 50)
        seq2.set_step_note(4, 62)
        seq2.start()

    ga, gb = _pair(setup)
    _compare(ga, gb, 12 * B)
    # the note override must have been RESTORED on both paths
    assert ga.get_param(1, "frequency") == gb.get_param(1, "frequency")
    _compare(ga, gb, 4 * B)


@pytest.mark.slow
def test_span_lfo_routes_and_sidechain():
    def setup(g):
        g.engine.set_lfo(0, frequency_hz=3.0, amount=0.8)
        g.engine.lfos[0].enabled = True
        g.engine.add_lfo_route(0, "ch0_kick", "frequency", 0.7)
        g.engine.add_lfo_route(0, "bass", "filter_cutoff", 0.5)
        g.sequencers[0].set_pattern_string("x.x.x.x.x.x.x.x.")
        g.sequencers[0].start()
        g.sequencers[4].set_pattern_string("x...x...x...x...")
        g.sequencers[4].start()
        g.set_effect_enabled(chain_mod.EFFECT_COMPRESSOR, True)
        g.sidechain_strip = 0

    ga, gb = _pair(setup)
    _compare(ga, gb, 8 * B)
    _compare(ga, gb, 4 * B)


@pytest.mark.slow
def test_span_granulator_racks_and_perf():
    def setup(g):
        rng = np.random.default_rng(5)
        g.granulator_load(rng.standard_normal(8192).astype(np.float32) * 0.3,
                          SR)
        g.granulator_set_param("density", 0.7)
        g.granulator_trigger(1.0)
        g.register_sampler_rack(0, arena_frames=1 << 14)
        buf = (np.sin(np.arange(2000) * 0.05) * 0.5).astype(np.float32)
        g.racks[0].set_buffer(3, np.stack([buf, buf], axis=1), SR)
        g.sampler_trigger(0, 3, 0.9)
        g.perf_chord_on(0, 0, 0, 0, 1, 4, 0.8)

    ga, gb = _pair(setup)
    _compare(ga, gb, 8 * B)
    for g in (ga, gb):
        g.perf_chord_off()
    _compare(ga, gb, 4 * B)


@pytest.mark.slow
def test_span_loops_and_clip_grid():
    def setup(g):
        from libgooey_tpu.mixer.stereo_buffer import StereoSampleBuffer

        n = int(SR * 60 / 120)  # one beat of ramp
        ramp = np.linspace(0, 1, n, dtype=np.float32)
        buf = StereoSampleBuffer.from_channels(ramp, ramp, SR, source_bpm=120.0)
        g.mixer.channels[0].set_buffer(buf)
        g.mixer.channels[0].playing = True
        g.mixer.clip_grid.transport_start(g.mixer.channels)

    ga, gb = _pair(setup)
    _compare(ga, gb, 8 * B)
    _compare(ga, gb, 4 * B)


@pytest.mark.slow
def test_span_peaks_and_midi_match():
    def setup(g):
        g.sequencers[0].set_pattern_string("x.x.x.x.x.x.x.x.")
        g.sequencers[0].start()

    ga, gb = _pair(setup)
    _compare(ga, gb, 8 * B)
    assert ga.drain_midi_out() == gb.drain_midi_out()
    pa = [ga.take_strip_peak(s) for s in range(5)]
    pb = [gb.take_strip_peak(s) for s in range(5)]
    np.testing.assert_allclose(pa, pb, atol=1e-5)


@pytest.mark.slow
def test_span_multi_trigger_block():
    """Two triggers for one voice in one block widen the span's trigger
    events to [V, K] slots (the per-block path's VoiceBlock multi-trigger
    mode) instead of falling back."""
    def setup(g):
        seq = g.sequencers[0]
        seq.set_pattern_string("xxxxxxxxxxxxxxxx")
        seq.start()

    ga, gb = _pair(setup)
    # 512-sample blocks at 120 BPM pack ~2 sixteenth steps per block
    _compare(ga, gb, 8 * B)


@pytest.mark.slow
def test_span_respects_host_automation_between_calls():
    def setup(g):
        g.sequencers[0].set_pattern_string("x.x.x.x.x.x.x.x.")
        g.sequencers[0].start()

    ga, gb = _pair(setup)
    _compare(ga, gb, 4 * B)
    for g in (ga, gb):
        g.set_param(0, "frequency", 0.9)
        g.set_master_gain(0.5)
        g.set_bpm(150.0)
    _compare(ga, gb, 6 * B)
