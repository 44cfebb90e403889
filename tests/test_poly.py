"""Poly synth bank vs per-sample oracle — POINTWISE.

The oracle replays the bank's exact split-increment mod-1 phase
(bass_oracle.ExactPhase), so there are no polyBLEP exclusion windows:
every sample must match to the −80 dBFS bar."""

import numpy as np

from libgooey_tpu.core.smoother import smoothing_coeff
from libgooey_tpu.instruments import poly as poly_mod
from poly_oracle import PolyVoiceOracle

SR = 44100.0
B = 512
COEFF = float(np.asarray(smoothing_coeff(SR)))
V = poly_mod.NUM_VOICES  # one synth


def render_lane(cfg, n_samples, events):
    """events: {sample: ("on", freq, vel) | ("off",)} on lane 0."""
    state = poly_mod.init_state(1, cfg)
    out = []
    for start in range(0, n_samples, B):
        off = np.full(V, B, np.int32)
        vel = np.zeros(V, np.float32)
        freq = np.zeros(V, np.float32)
        rel = np.full(V, B, np.int32)
        for s, ev in events.items():
            if start <= s < start + B:
                if ev[0] == "on":
                    off[0] = s - start
                    freq[0] = ev[1]
                    vel[0] = ev[2]
                else:
                    rel[0] = s - start
        state, y = poly_mod.render_block(
            state, off, vel, np.int32(start), trig_freq=freq,
            release_offset=rel, sample_rate=SR, block_size=B,
            smooth_coeff=COEFF,
        )
        out.append(np.asarray(y[0]))  # synth 0 mixed lane
    return np.concatenate(out)[:n_samples]


def run_oracle(cfg, n_samples, events):
    o = PolyVoiceOracle(
        {k: getattr(cfg, k) for k in poly_mod.PARAM_NAMES}, SR
    )
    out = np.zeros(n_samples, np.float32)
    for n in range(n_samples):
        ev = events.get(n)
        if ev is not None:
            if ev[0] == "on":
                o.trigger(ev[1], ev[2])
            else:
                o.release()
        out[n] = o.tick()
    return out, o


def check(cfg, n_samples, events):
    got = render_lane(cfg, n_samples, events)
    want, o = run_oracle(cfg, n_samples, events)
    d = np.abs(got - want)
    assert d.max() < 1e-4, d.max()
    assert np.abs(got).max() > 1e-3


def test_poly_voice_matches_oracle_default():
    check(poly_mod.PolySynthConfig.default(), 3072,
          {100: ("on", 261.6256, 0.9)})


def test_poly_release_ramp_matches():
    """Sustain hold then a manual release: the linear ramp from the frozen
    amplitude must match sample-for-sample."""
    check(poly_mod.PolySynthConfig.pluck(), 3072,
          {10: ("on", 329.6276, 1.0), 1200: ("off",)})


def test_poly_retrigger_cancels_release():
    check(poly_mod.PolySynthConfig.keys(), 4096,
          {0: ("on", 220.0, 0.8), 900: ("off",), 1800: ("on", 440.0, 1.0)})
