"""Granulator device path vs a per-sample scalar transcription.

The host scheduler (RNG, spawn timing) is deterministic host code tested
elsewhere; here hand-built SpawnEvents drive the device kernel so the
windowed cubic reads, release fades, 1/sqrt(N) compensation smoothing and
4x-oversampled drive are verified to <2e-4."""

import jax.numpy as jnp
import numpy as np

from libgooey_tpu.core.smoother import smoothing_coeff
from libgooey_tpu.instruments import granulator as gran
from oversample_oracle import OracleOversampler

SR = 44100.0
B = 512
F = np.float32


def make_events(entries):
    """entries: list of dicts with slot/offset/duration/src_pos/step/shape/
    vel/rel_total/copy_from."""
    K = gran.MAX_SPAWNS_PER_BLOCK
    cols = {
        "slot": np.full(K, -1, np.int32), "offset": np.zeros(K, np.int32),
        "duration": np.ones(K, np.float32), "src_pos": np.zeros(K, np.float32),
        "step": np.ones(K, np.float32), "shape": np.full(K, 2.0, np.float32),
        "vel": np.zeros(K, np.float32), "rel_total": np.zeros(K, np.float32),
        "copy_from": np.full(K, -1, np.int32),
    }
    for k, e in enumerate(entries):
        for name, v in e.items():
            cols[name][k] = v
    return gran.SpawnEvents(**{k: jnp.asarray(v) for k, v in cols.items()})


def empty_events():
    return make_events([])


def cubic(buf, pos):
    L = len(buf)
    pos = min(max(pos, 0.0), L - 1.0)
    i1 = int(np.floor(pos))
    frac = F(pos - np.floor(pos))
    p0 = buf[max(i1 - 1, 0)]
    p1 = buf[i1]
    p2 = buf[min(i1 + 1, L - 1)]
    p3 = buf[min(i1 + 2, L - 1)]
    a0 = F(-0.5 * p0 + 1.5 * p1 - 1.5 * p2 + 0.5 * p3)
    a1 = F(p0 - 2.5 * p1 + 2.0 * p2 - 0.5 * p3)
    a2 = F(-0.5 * p0 + 0.5 * p2)
    return F(((a0 * frac + a1) * frac + a2) * frac + p1)


def test_granulator_device_path_matches_scalar_oracle():
    rng = np.random.RandomState(7)
    buf = (rng.standard_normal(4096) * 0.4).astype(np.float32)
    cfg = gran.GranulatorConfig(drive=0.6, volume=0.8)
    state = gran.init_state(buf, SR, cfg)

    grains = [
        dict(slot=0, offset=40, duration=700.0, src_pos=100.0, step=1.0,
             shape=2.0, vel=0.9),
        dict(slot=1, offset=300, duration=900.0, src_pos=2000.0, step=-0.5,
             shape=3.5, vel=0.7),
        # a soft-stolen copy of grain 0 moved into the release pool
        dict(slot=gran.MAX_GRAINS, offset=200, rel_total=180.0, copy_from=0),
    ]
    blocks = [make_events(grains), empty_events()]

    got = []
    st = state
    coeff = float(np.asarray(smoothing_coeff(SR)))
    for i, ev in enumerate(blocks):
        st, y = gran.render_block(st, ev, np.int32(i * B), sample_rate=SR,
                                  block_size=B, smooth_coeff=coeff)
        got.append(np.asarray(y))
    got = np.concatenate(got)

    # ---- scalar transcription --------------------------------------------------
    NEVER = -(2**30)
    lanes = [dict(spawn=NEVER, dur=1.0, src=0.0, step=1.0, shape=2.0, vel=0.0,
                  rstart=-1, rtotal=0.0) for _ in range(gran.TOTAL)]
    for g in grains:
        lane = lanes[g["slot"]]
        if g.get("copy_from", -1) >= 0:
            src = dict(lanes[g["copy_from"]])
            lane.update(src)
            lane["rstart"] = g["offset"]
            lane["rtotal"] = g["rel_total"]
        else:
            lane.update(spawn=g["offset"], dur=g["duration"], src=g["src_pos"],
                        step=g["step"], shape=g["shape"], vel=g["vel"],
                        rstart=-1, rtotal=0.0)

    comp = F(1.0)
    comp_coeff = F(np.asarray(smoothing_coeff(SR, 10.0)))
    q = F(1.0 - coeff)
    drive_cur, vol_cur = F(cfg.drive), F(cfg.volume)
    ovs = OracleOversampler(4)
    comp_ws = F(np.tanh(0.5) / np.tanh(0.5 * gran.DRIVE_INTERNAL))
    want = np.zeros(2 * B, np.float32)
    for n in range(2 * B):
        raw = F(0.0)
        count = 0
        for lane in lanes:
            age = n - lane["spawn"]
            if not (0 <= age < lane["dur"]):
                continue
            rel_gain = F(1.0)
            if lane["rstart"] >= 0 and lane["rtotal"] > 0:
                rel_gain = F(min(max(
                    1.0 - (n - lane["rstart"]) / max(lane["rtotal"], 1.0),
                    0.0), 1.0))
            if rel_gain <= 0.0:
                continue
            count += 1
            phase = min(max(age / max(lane["dur"], 1.0), 0.0), 1.0)
            window = F(max(np.sin(np.pi * phase), 0.0) ** lane["shape"])
            s = cubic(buf, lane["src"] + lane["step"] * age)
            raw = F(raw + s * window * rel_gain * lane["vel"])
        tgt = F(1.0 / np.sqrt(max(count, 1)) if count > 0 else 1.0)
        comp = F(comp + comp_coeff * (tgt - comp))
        raw = F(raw * comp)
        # settled drive/volume smoothing (targets == current here)
        shaped = ovs.process(raw, lambda v: np.tanh(v * gran.DRIVE_INTERNAL)
                             * comp_ws)
        mix = drive_cur
        driven = raw if mix <= 1e-4 else F(raw * (1.0 - mix) + shaped * mix)
        want[n] = F(driven * vol_cur)

    err = np.abs(got - want).max()
    assert err < 1e-4, err
    assert np.abs(got).max() > 1e-3
