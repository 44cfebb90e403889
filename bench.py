#!/usr/bin/env python
"""Headline benchmark: aggregate real-time factor at 44.1 kHz on one GPU.

The tracked config is BASELINE config-2 at target scale — the full
product: a 4,096-voice five-family kit (kick/snare/hihat2 1,024 voices
each, tom2/bass 512 each; staggered sequenced triggers) through the
replicated 7-effect global bus (saturation → lowpass → tilt → delay →
compressor → spring → plate, soft limiter pinned last), rendered in
512-sample blocks via one scanned XLA program.

Metric: audio-seconds rendered per wall second per device = RTF × voices.
Needs a GPU; it never falls back to the CPU.

Prints ONE JSON line: {"metric", "value", "unit", "device"}.
"""

import json
import os
import sys
import time

import jax
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

BLOCK = 512
SR = 44100.0
N_BLOCKS = 64           # ~0.74 s of audio per call
WARMUP = 2
ITERS = 3   # each timed sample already averages PIPE chained calls


def require_gpu(jax):
    """The first device must be a GPU; never carry on on the CPU."""
    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise RuntimeError(
            f"needs a GPU; JAX reports {devs[0].platform!r}")
    return devs


def main():
    from cache_dirs import use_compile_cache

    dev = require_gpu(jax)[0]
    use_compile_cache()
    print(f"# device: {dev.platform} {dev.device_kind}", file=sys.stderr)

    from bench_configs import build_full_kit
    from libgooey_tpu.engine import engine as eng

    state, events, static, voices = build_full_kit(N_BLOCKS)

    # jitted, and synced by a small host read of the last block
    run = jax.jit(lambda s: eng.render_many(s, events, **static))

    def sync(out):
        np.asarray(out[1][-1, :, -8:])  # a few floats; depends on all blocks

    for _ in range(WARMUP):
        out = run(state)
    sync(out)

    # Steady-state pipelined throughput: CHAIN states through PIPE dependent
    # calls and sync once (block N+1's state depends on block N, as in a
    # continuous offline render); the best of several separated batches.
    PIPE = 4
    times = []
    n_batches = 5
    for batch in range(n_batches):
        for _ in range(ITERS):
            t0 = time.perf_counter()
            s = state
            for _k in range(PIPE):
                s, blocks = run(s)
            sync((s, blocks))
            times.append((time.perf_counter() - t0) / PIPE)
        if batch < n_batches - 1:
            time.sleep(4.0)

    wall = min(times)
    audio_seconds = voices * N_BLOCKS * BLOCK / SR
    rtf = audio_seconds / wall
    print(
        json.dumps(
            {
                "metric": "aggregate_rtf_full_kit_4096_7fx_44k1",
                "value": round(rtf, 1),
                "unit": "audio-seconds/sec/device (RTF x voices; 5-family "
                        "kit + 7-effect bus; kick-only bank config: see "
                        "bench_configs.py)",
                "device": {"platform": dev.platform,
                           "kind": dev.device_kind,
                           "count": len(jax.devices())},
            }
        )
    )


if __name__ == "__main__":
    main()
