"""Sample-accurate trigger timing + multi-trigger-per-block semantics.

The reference applies sequenced triggers at their exact in-block sample
offsets on the product (FFI) path (ffi.rs:1152-1205) and retriggers voices
per-sample, so several hits can land in one 512-sample block.  These tests
pin both behaviors on the JAX rebuild:

* GooeyEngine sequenced swing onsets land at the exact samples the
  sequencer reports (mirrors tests/sequencer_armed_start.rs swing spans);
* ``[V, K]`` trigger-slot packing matches the legacy single-trigger path
  bit-for-bit, and a mid-block retrigger equals a fresh voice triggered at
  the same sample;
* per-step note overrides on several strips in one block all restore.
"""

import numpy as np

from libgooey_tpu.core.smoother import smoothing_coeff
from libgooey_tpu.engine.engine import Engine
from libgooey_tpu.gooey import GooeyEngine
from libgooey_tpu.instruments import kick as kick_mod
from libgooey_tpu.instruments import tom2 as tom2_mod

SR = 44100.0
B = 512


def _onsets(mono: np.ndarray, eps: float = 1e-7) -> np.ndarray:
    """Sample indices where the signal transitions silence -> sound."""
    active = np.abs(mono) > eps
    idx = np.nonzero(active[1:] & ~active[:-1])[0] + 1
    if active[0]:
        idx = np.concatenate([[0], idx])
    return idx


def test_ffi_sequenced_swing_onsets_sample_exact():
    """Swing onsets on the gooey render path match the sequencer's exact
    trigger samples — not the 512-block grid (round-1 regression)."""
    g = GooeyEngine()
    g.set_bpm(240)  # 2756.25 samples per 16th: never a multiple of 512
    # short, click-free kick so each hit decays fully before the next
    g.set_param(0, "amp_decay", 0.005)
    g.set_param(0, "oscillator_decay", 0.005)
    seq = g.sequencers[0]
    n_hits = 6
    for i in range(n_hits):
        seq.set_step(i, True)
        seq.set_step_velocity(i, 1.0)
    seq.set_swing(0.68)
    seq.start()
    total = int(6 * 2757) + B
    out = g.render(total)
    mono = out[0::2]

    expected = np.array(sorted(s for (s, name, _v) in g.drain_midi_out()
                               if name == "ch0_kick"))
    onsets = _onsets(mono)
    assert len(onsets) >= n_hits, (onsets, expected)
    onsets = onsets[:n_hits]
    expected = expected[:n_hits]
    # every hit becomes audible 0-8 samples AFTER its exact trigger sample
    # (the 1 ms attack ramp crosses the detection threshold a few samples
    # in).  The round-1 bug block-quantized triggers, firing hits up to 511
    # samples EARLY (negative lag) — this bound catches it per hit.
    lags = onsets - expected
    assert np.all((lags >= 0) & (lags <= 8)), (onsets, expected, lags)
    # sanity: the expected spacing is NOT block-aligned (so the assertion
    # above genuinely distinguishes exact offsets from the 512 grid)
    assert np.any(np.diff(expected) % B != 0)


def test_kick_vk1_matches_legacy_path():
    """[V, 1] slot arrays produce bit-identical audio to the legacy [V]
    single-trigger path."""
    sc = smoothing_coeff(SR)
    state = kick_mod.init_state(3)
    offs = np.array([0, 100, B], np.int32)
    vels = np.array([1.0, 0.5, 0.0], np.float32)
    kw = dict(sample_rate=SR, block_size=B, smooth_coeff=sc)
    st1, out1 = kick_mod.render_block(state, offs, vels, np.int32(0), **kw)
    st2, out2 = kick_mod.render_block(state, offs[:, None], vels[:, None],
                                      np.int32(0), **kw)
    np.testing.assert_array_equal(np.asarray(out1), np.asarray(out2))
    np.testing.assert_array_equal(
        np.asarray(st1.trig_sample), np.asarray(st2.trig_sample)
    )


def test_tom2_mid_block_retrigger_equals_fresh_voice():
    """A second trigger at offset o must restart the voice: from o on, a
    (0, o)-triggered voice equals a voice triggered only at o.

    Tolerance is ulp-scale, not bit-exact: the retriggered voice's samples
    come from trigger slot 2 and the fresh voice's from slot 1, and XLA may
    contract/fuse the two slot iterations differently (machine-dependent
    FMA choices), drifting mathematically-identical values by ~2e-6 — two
    orders under the suite's 1e-4 (−80 dBFS) fidelity bar.  The state
    RESET itself (trig_sample latch) is still asserted exactly.
    """
    state = tom2_mod.init_state(2)
    o = 300
    offs = np.array([[0, o], [o, B]], np.int32)  # voice 1: single hit at o
    vels = np.ones((2, 2), np.float32)
    _st, out = tom2_mod.render_block(
        state, offs, vels, np.int32(0), sample_rate=SR, block_size=B
    )
    out = np.asarray(out)
    assert np.abs(out[0, :o]).max() > 0.0        # first hit audible
    assert np.abs(out[1, :o]).max() == 0.0       # fresh voice silent pre-o
    np.testing.assert_allclose(out[0, o:], out[1, o:], atol=1e-5, rtol=0.0)
    np.testing.assert_array_equal(np.asarray(_st.trig_sample), [o, o])


def test_engine_two_triggers_one_block():
    """Engine.trigger(offset=...) lands both hits at their exact samples."""
    eng = Engine(sample_rate=SR, block_size=B)
    eng.add_instrument("t", "tom2")
    eng.render(B)  # settle
    eng.trigger("t", 1.0, offset=100)
    eng.trigger("t", 1.0, offset=300)
    _out, mono = eng.render_block()
    mono = np.asarray(mono)
    assert np.abs(mono[:100]).max() == 0.0
    first = _onsets(mono)
    # tom2's attack crosses the detection threshold ~9 samples in
    assert len(first) >= 1 and 100 <= first[0] <= 112, first
    # the retrigger restarts the attack: energy present right after 300
    assert np.abs(mono[300:310]).max() > 0.0


def test_note_override_restores_every_strip():
    """Two note-bearing steps on different strips in one block: BOTH
    frequency params must restore after the block (round-1 leak)."""
    g = GooeyEngine()
    f0 = g.get_param(0, "frequency")
    f1 = g.get_param(1, "frequency")
    g.sequencers[0].set_step_with_settings(0, True, 1.0, note=60)
    g.sequencers[1].set_step_with_settings(0, True, 1.0, note=64)
    g.sequencers[0].start()
    g.sequencers[1].start()
    g.render(B)
    assert g.get_param(0, "frequency") == f0
    assert g.get_param(1, "frequency") == f1
