"""HiHat v1 / Tom v1 banks vs dedicated per-sample oracles (<=1e-4).

Completes the oracle coverage matrix: every instrument
family is pinned by a standalone per-sample oracle file.  These extend the
inline transcriptions in test_drums.py with open-hat sustain paths,
mid-stream retriggers, and live parameter smoothing.  Reference behavior:
src/instruments/hihat.rs:498-672, src/instruments/tom.rs.
"""

import dataclasses

import numpy as np

from hihat_oracle import HiHatOracle
from tom_oracle import TomOracle
from libgooey_tpu.core.smoother import smoothing_coeff
from libgooey_tpu.instruments import hihat as hihat_mod
from libgooey_tpu.instruments import tom as tom_mod

SR = 44100.0
B = 512
COEFF = float(np.asarray(smoothing_coeff(SR)))


def render_bank(mod, config, n_samples, triggers, param_changes=None, **kw):
    """``triggers``: {sample: velocity}; ``param_changes``: {sample-block:
    {param: target}} applied at the containing block's start."""
    state = mod.init_state(1, config)
    targets = np.broadcast_to(
        config.as_array(), (1, mod.NUM_PARAMS)).copy()
    out = []
    for start in range(0, n_samples, B):
        if param_changes:
            for s, changes in param_changes.items():
                if start <= s < start + B:
                    for k, v in changes.items():
                        targets[:, mod.PARAM_INDEX[k]] = v
                    state = state._replace(
                        params=state.params.with_targets(targets))
        offs = [(t - start, v) for t, v in triggers.items()
                if start <= t < start + B]
        if len(offs) <= 1:
            off = np.full(1, B, np.int32)
            vel = np.zeros(1, np.float32)
            if offs:
                off[0], vel[0] = offs[0]
        else:
            off = np.full((1, len(offs)), B, np.int32)
            vel = np.zeros((1, len(offs)), np.float32)
            for k, (o, v) in enumerate(sorted(offs)):
                off[0, k], vel[0, k] = o, v
        state, y = mod.render_block(
            state, off, vel, np.int32(start), sample_rate=SR, block_size=B,
            smooth_coeff=COEFF, **kw)
        out.append(np.asarray(y[0]))
    return np.concatenate(out)[:n_samples]


def run_oracle(oracle, n_samples, triggers, param_changes=None):
    out = np.zeros(n_samples, np.float32)
    for n in range(n_samples):
        if param_changes and n % B == 0:
            for s, changes in param_changes.items():
                if n == (s // B) * B:
                    for k, v in changes.items():
                        oracle.set_param(k, v)
        if n in triggers:
            oracle.trigger(triggers[n])
        out[n] = oracle.tick()
    return out


def cfg_dict(cfg, names):
    return {k: getattr(cfg, k) for k in names}


# --- HiHat v1 -----------------------------------------------------------------


def test_hihat_closed_matches_oracle_retrigger():
    cfg = hihat_mod.HiHatConfig.closed_default()
    trig = {7: 0.8, 900: 1.0, 1400: 0.35}
    got = render_bank(hihat_mod, cfg, 2048, trig)
    o = HiHatOracle(cfg_dict(cfg, hihat_mod.PARAM_NAMES), SR, coeff=COEFF,
                    is_open=False)
    want = run_oracle(o, 2048, trig)
    err = np.abs(got - want).max()
    assert err < 1e-4, err
    assert np.abs(got).max() > 0.01


def test_hihat_open_matches_oracle():
    """Open-hat path: sustain wash envelopes (hihat.rs:433-447)."""
    cfg = hihat_mod.HiHatConfig.open_default()
    trig = {11: 0.9}
    got = render_bank(hihat_mod, cfg, 2048, trig)
    o = HiHatOracle(cfg_dict(cfg, hihat_mod.PARAM_NAMES), SR, coeff=COEFF,
                    is_open=True)
    want = run_oracle(o, 2048, trig)
    err = np.abs(got - want).max()
    assert err < 1e-4, err
    assert np.abs(got[1800:]).max() > 1e-4  # the wash actually sustains


def test_hihat_matches_oracle_with_param_smoothing():
    cfg = hihat_mod.HiHatConfig.closed_tight()
    trig = {3: 1.0, 1100: 0.7}
    changes = {B: {"filter": 0.9, "frequency": 0.8}, 3 * B: {"volume": 0.3}}
    got = render_bank(hihat_mod, cfg, 2560, trig, changes)
    o = HiHatOracle(cfg_dict(cfg, hihat_mod.PARAM_NAMES), SR, coeff=COEFF,
                    is_open=False)
    want = run_oracle(o, 2560, trig, changes)
    err = np.abs(got - want).max()
    assert err < 1e-4, err


# --- Tom v1 -------------------------------------------------------------------


def test_tom_matches_oracle_retrigger():
    cfg = dataclasses.replace(tom_mod.TomConfig.mid_tom(), punch=0.6,
                              pitch_drop=0.7)
    trig = {90: 0.8, 1200: 1.0}
    got = render_bank(tom_mod, cfg, 2048, trig, max_harmonics=128)
    o = TomOracle(cfg_dict(cfg, tom_mod.PARAM_NAMES), SR, coeff=COEFF,
                  max_harmonics=128)
    want = run_oracle(o, 2048, trig)
    err = np.abs(got - want).max()
    assert err < 1e-4, err
    assert np.abs(got).max() > 0.01


def test_tom_low_matches_oracle_with_param_smoothing():
    cfg = tom_mod.TomConfig.low_tom()
    trig = {5: 1.0}
    changes = {B: {"frequency": 0.6, "pitch_drop": 0.1},
               2 * B: {"volume": 0.4}}
    got = render_bank(tom_mod, cfg, 1536, trig, changes, max_harmonics=128)
    o = TomOracle(cfg_dict(cfg, tom_mod.PARAM_NAMES), SR, coeff=COEFF,
                  max_harmonics=128)
    want = run_oracle(o, 1536, trig, changes)
    err = np.abs(got - want).max()
    assert err < 1e-4, err
