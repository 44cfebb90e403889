"""Bass bank vs per-sample oracle — POINTWISE.

The oracle replays the bank's exact split-increment mod-1 phase
(bass_oracle.ExactPhase mirrors ops.scan.phase_cumsum_reset), so its wrap
samples land on the same side as the bank's and the old ±2.5-sample
polyBLEP exclusion windows are gone: every sample must match to <2e-4
(≈ −80 dBFS at full scale), including inside correction windows
.
"""

import dataclasses

import numpy as np

from bass_oracle import BassOracle
from libgooey_tpu.core.smoother import smoothing_coeff
from libgooey_tpu.instruments import bass as bass_mod

SR = 44100.0
B = 512
COEFF = float(np.asarray(smoothing_coeff(SR)))


def render_bank(config, n_samples, trigger_at, velocity, param_changes=None):
    state = bass_mod.init_state(1, config)
    targets = np.broadcast_to(config.as_array(), (1, bass_mod.NUM_PARAMS)).copy()
    out = []
    for start in range(0, n_samples, B):
        if param_changes:
            for s, changes in param_changes.items():
                if start <= s < start + B:
                    for k, v in changes.items():
                        targets[:, bass_mod.PARAM_INDEX[k]] = v
                    state = state._replace(params=state.params.with_targets(targets))
        off = np.full(1, B, np.int32)
        vel = np.zeros(1, np.float32)
        if start <= trigger_at < start + B:
            off[0] = trigger_at - start
            vel[0] = velocity
        state, y = bass_mod.render_block(
            state, off, vel, np.int32(start),
            sample_rate=SR, block_size=B, smooth_coeff=COEFF,
        )
        out.append(np.asarray(y[0]))
    return np.concatenate(out)[:n_samples]


def run_oracle(config, n_samples, trigger_at, velocity, param_changes=None):
    cfg = {k: getattr(config, k) for k in bass_mod.PARAM_NAMES}
    o = BassOracle(cfg, SR, coeff=COEFF)
    out = np.zeros(n_samples, np.float32)
    for n in range(n_samples):
        if param_changes:
            for s, changes in param_changes.items():
                if n == (s // B) * B:
                    for k, v in changes.items():
                        o.set_param(k, v)
        if n == trigger_at:
            o.trigger(velocity)
        out[n] = o.tick()
    return out, o


def assert_matches(got, want, oracle, tight=2e-4):
    d = np.abs(got - want)
    assert d.max() < tight, d.max()


def test_bass_matches_oracle_acid():
    cfg = bass_mod.BassConfig.acid()
    got = render_bank(cfg, 2048, 100, 0.9)
    want, o = run_oracle(cfg, 2048, 100, 0.9)
    assert_matches(got, want, o)
    assert np.abs(got).max() > 0.05  # audible


def test_bass_matches_oracle_overdriven_square():
    cfg = dataclasses.replace(
        bass_mod.BassConfig.acid(), osc_shape=1.0, overdrive=0.7,
        detune_level=0.5, detune_amount=0.6, filter_env_amount=0.8,
        filter_resonance=0.6,
    )
    got = render_bank(cfg, 2048, 37, 1.0)
    want, o = run_oracle(cfg, 2048, 37, 1.0)
    assert_matches(got, want, o)


def test_bass_sine_path_matches_everywhere():
    """Sub-sine + waveshaper + swept resonant filter: no blep windows, so
    the bank must match the oracle at every sample."""
    cfg = dataclasses.replace(
        bass_mod.BassConfig.acid(), sub_level=0.9, osc_level=0.0,
        detune_level=0.0, overdrive=0.5,
    )
    got = render_bank(cfg, 2048, 100, 0.9)
    want, _ = run_oracle(cfg, 2048, 100, 0.9)
    err = np.abs(got - want).max()
    assert err < 1e-4, err


def test_bass_matches_oracle_with_param_smoothing():
    cfg = bass_mod.BassConfig.acid()
    changes = {B: {"filter_cutoff": 0.9, "osc_shape": 0.8},
               3 * B: {"volume": 0.3}}
    got = render_bank(cfg, 2560, 10, 0.8, changes)
    want, o = run_oracle(cfg, 2560, 10, 0.8, changes)
    assert_matches(got, want, o)


def test_bass_retrigger_and_tuning():
    """Live tuning shifts pitch (+12 semitones ≈ 2x zero crossings)."""
    cfg = dataclasses.replace(bass_mod.BassConfig.acid(), tuning=0.5)
    a = render_bank(cfg, 4096, 0, 1.0)
    up = render_bank(dataclasses.replace(cfg, tuning=1.0), 4096, 0, 1.0)
    zc = lambda x: int(np.sum(np.abs(np.diff(np.sign(x[200:3000]))) > 0))
    assert zc(up) > 1.5 * zc(a)
