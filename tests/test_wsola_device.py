"""Device WSOLA search vs the host (numpy) oracle: identical hop choices.

The coarse-to-fine NCC search runs on device as two
fixed-size einsums + argmax (ops/wsola_search.py), returning candidate
*indices* that the host maps back through its own f64 ranges — so when the
indices agree, the whole downstream hop plan is bit-identical.  These
fixtures (integer ramp, seeded noise, wrap-around window) pin exactly
that.
"""

import numpy as np

from libgooey_tpu.mixer.loop_channel import LoopWindow
from libgooey_tpu.mixer.stereo_buffer import StereoSampleBuffer
from libgooey_tpu.mixer import wsola

SR = 44100.0
B = 512


class _Buf:
    """Minimal buffer stand-in: .left/.right/.sample_rate."""

    def __init__(self, mono, sr=SR):
        self.left = np.asarray(mono, np.float32) * 0.5
        self.right = np.asarray(mono, np.float32) * 0.5
        self.sample_rate = sr


def run(mono, warp, n_blocks, use_device, window=None, speed=1.0):
    L = len(mono)
    win = window or LoopWindow(lo=0.0, hi=float(L), span=float(L),
                               wraps=False, len=float(L))
    host = wsola.WsolaHost(SR, initial_cursor=win.lo, use_device=use_device)
    buf = _Buf(mono)
    starts, plans = [], []
    for _ in range(n_blocks):
        pos, w, cur = host.plan_block(B, buf, win, 1.0, speed, warp)
        starts.append(float(host.cur_start_v))
        plans.append((pos.copy(), w.copy()))
    return starts, plans


def assert_identical(mono, warp, n_blocks=24, window=None, speed=1.0):
    s_host, p_host = run(mono, warp, n_blocks, False, window, speed)
    s_dev, p_dev = run(mono, warp, n_blocks, True, window, speed)
    assert s_host == s_dev, (s_host, s_dev)
    for (ph, wh), (pd, wd) in zip(p_host, p_dev):
        np.testing.assert_array_equal(ph, pd)
        np.testing.assert_array_equal(wh, wd)


def test_device_search_matches_host_on_noise():
    mono = np.random.RandomState(0).randn(1 << 15).astype(np.float32) * 0.4
    assert_identical(mono, warp=1.7)


def test_device_search_matches_host_on_ramp():
    mono = (np.arange(1 << 15) % 1000 / 1000.0).astype(np.float32)
    assert_identical(mono, warp=0.6)
    # dithered variant breaks the sawtooth's periodic NCC self-similarity
    rng = np.random.RandomState(1)
    assert_identical((mono + rng.randn(1 << 15) * 0.01).astype(np.float32),
                     warp=0.6)


def test_device_search_matches_host_tone_and_wrap_window():
    t = np.arange(1 << 15)
    mono = np.sin(2 * np.pi * 220.0 * t / SR).astype(np.float32)
    assert_identical(mono, warp=2.0)
    # wrap-around loop region: [lo, len) U [0, hi)
    L = float(1 << 15)
    win = LoopWindow(lo=L * 0.75, hi=L * 0.25, span=L * 0.5, wraps=True,
                     len=L)
    noise = np.random.RandomState(3).randn(1 << 15).astype(np.float32) * 0.4
    assert_identical(noise, warp=1.3, window=win)
