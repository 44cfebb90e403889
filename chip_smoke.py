#!/usr/bin/env python
"""Bring-up check: the render path on one GPU, compared with the CPU.

    python chip_smoke.py                  # every phase, one GPU
    python chip_smoke.py --only kernels   # one phase (plus the device check)
    python chip_smoke.py --kit-ab         # also time the kit on lax.scan

Phases, in order; each prints one line with its wall and compile time
(compile seconds are summed over threads: the span session renders and
the kit compiles in worker threads beside the per-block session):

1. ``device``: JAX must report a GPU.  Prints the device kind and count and
   ``nvidia-smi``'s name and power limit.
2. ``product``: a product session at reference capacity built through the
   C-ABI layer (``capi``), rendered for 2 s through the per-block path
   (512-frame calls) and through the planned-span path (multi-block
   calls).  Each must be finite, not silent, within 1e-4 per sample of the
   same session rendered on the CPU, and the PreservePitch loop channels
   must land on the same hop starts.
3. ``kit``: ``bench_configs.build_full_kit`` (4,096 voices, 7-effect bus,
   limiter) through ``engine.render_many`` for 64 blocks: finite, first
   blocks within 1e-4 of the CPU, memory analysis, ms per block (with
   ``--kit-ab``, also with every recurrence on ``lax.scan``).
4. ``kernels``: the sequential-recurrence kernel (``ops/recurrence.py``)
   against ``lax.scan`` at real widths, with A/B times.

The CPU reference renders in a child process with ``JAX_PLATFORMS=cpu``,
which never opens the card.  The last line of stdout is one JSON object,
printed only when every phase passed.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

SR = 44100.0
B = 512
SESSION_BLOCKS = 176        # 2.04 s of audio
SPAN_CALLS = 4              # the span path renders 44 blocks per call
KIT_BLOCKS = 64
KIT_CHECK_BLOCKS = 4        # blocks compared with the CPU
TOL = 1e-4                  # the repo's per-sample bar
PHASES = ("product", "kit", "kernels")

_COMPILE_S = [0.0]


def _count_compile(event, duration, **_kw):
    if event.startswith("/jax/core/compile/"):
        _COMPILE_S[0] += duration


def card_line() -> str:
    """``name, power.limit`` from nvidia-smi (a child that never imports JAX)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# --- the product session ---------------------------------------------------


def _noise(rng, n, scale=0.3):
    return (rng.standard_normal(n) * scale).astype(np.float32)


def build_session(capi, seed: int = 0) -> int:
    """A session at reference capacity (BASELINE.md's capacity row):
    4 sequenced kit strips + bass with 16-step patterns, the poly bank with
    a chord, the granulator at its 64+16 grain capacity, 4 sampler racks x
    16 loaded slots with voices sounding, 4 loop channels (two in
    PreservePitch), 8 LFOs with routes, all 10 bus effects and two submix
    tracks.  Deterministic in ``seed``."""
    rng = np.random.default_rng(seed)
    h = capi.engine_new(SR)
    capi.engine_set_bpm(h, 128.0)

    patterns = (0b1000100010001000, 0b0000100000001000,
                0b1010101010101010, 0b0010000000100100,
                0b1001001010010010)
    for ch, bits in enumerate(patterns):
        capi.engine_sequencer_set_instrument_pattern(h, ch, bits)
    for step, note in enumerate((36, 36, 43, 36, 48, 36, 41, 39) * 2):
        capi.engine_sequencer_set_instrument_step_note(h, 4, step, note)
    for ch in range(5):
        capi.engine_set_instrument_pan(h, ch, 0.2 + 0.15 * ch)
        capi.engine_sequencer_start(h, ch)

    capi.engine_poly_set_preset(h, 4)
    capi.engine_poly_trigger_chord(h, 0, 0, 0, 9, 4, 4, 0.8)

    tone = np.sin(2 * np.pi * 220.0 * np.arange(int(SR)) / SR)
    grain_src = (0.5 * tone).astype(np.float32) + _noise(rng, int(SR), 0.05)
    assert capi.engine_granulator_set_buffer(h, grain_src, SR) == 1
    capi.engine_granulator_set_param(h, 1, 1.0)   # grain length
    capi.engine_granulator_set_param(h, 4, 1.0)   # density
    capi.engine_granulator_snap_params(h)
    capi.engine_granulator_trigger(h, 1.0)

    drum_bus = capi.engine_mixer_add_track(h, "DrumBus")
    fx_bus = capi.engine_mixer_add_track(h, "FxBus")
    for _ in range(4):
        rack = capi.engine_sampler_register(h)
        assert rack >= 0
        src = capi.engine_sampler_get_source_id(h, rack)
        assert capi.engine_mixer_route_source(
            h, src, drum_bus if rack % 2 == 0 else fx_bus) == 1
        for slot in range(16):
            n = int(SR * (0.1 + 0.02 * slot))
            f = 110.0 * (1 + slot)
            pcm = (0.4 * np.sin(2 * np.pi * f * np.arange(n) / SR)
                   ).astype(np.float32)
            assert capi.engine_sampler_set_slot_buffer(
                h, rack, slot, pcm, 1, SR) == 1
        for slot in range(0, 16, 2):
            assert capi.engine_sampler_trigger(h, rack, slot, 0.8) == 1

    for ch in range(4):
        frames = int(2 * SR)
        inter = np.stack([_noise(rng, frames), _noise(rng, frames)], 1)
        assert capi.engine_loop_load(h, ch, inter.reshape(-1), 2, SR,
                                     120.0) == 1
        mode = 2 if ch < 2 else 1          # PreservePitch, Resample
        assert capi.engine_loop_set_pitch_mode(h, ch, mode) == 1
        capi.engine_loop_set_gain(h, ch, 0.5)
        capi.engine_loop_set_playing(h, ch, 1)
    capi.engine_transport_start(h)

    routes = ((0, 0, 0), (1, 0, 1), (2, 1, 0), (3, 1, 2),
              (4, 2, 0), (5, 2, 1), (6, 4, 6), (7, 4, 0))
    for lfo, ch, pid in routes:
        capi.engine_set_lfo_timing(h, lfo, lfo)
        capi.engine_set_lfo_amount(h, lfo, 0.3)
        capi.engine_set_lfo_enabled(h, lfo, 1)
        assert capi.engine_add_lfo_route(h, lfo, ch, pid, 0.5) == 1

    for eid in range(10):
        capi.engine_set_effect_enabled(h, eid, 1)
    capi.engine_set_effect_param(h, 7, 0, 3.0)   # waveshaper drive
    capi.engine_set_effect_param(h, 7, 1, 0.5)   # waveshaper mix
    capi.engine_set_effect_param(h, 8, 0, 4.0)   # feedback shaper drive
    capi.engine_set_effect_param(h, 8, 3, 0.5)   # feedback shaper mix
    return h


def open_session() -> int:
    """The session with the WSOLA correlation search on the device."""
    from libgooey_tpu import capi
    from libgooey_tpu.mixer import wsola

    wsola.USE_DEVICE_SEARCH = True
    return build_session(capi)


def render_session(h: int, path: str):
    """Render session ``h`` through ``path`` ("block" or "span").

    Returns ``(stereo[frames, 2], hops[checkpoints, 4, 2])``: the loop
    channels' cursors and current grain starts at each checkpoint."""
    from libgooey_tpu import capi

    e = capi._e(h)
    per_span = SESSION_BLOCKS // SPAN_CALLS
    if path == "block":
        calls = [B] * SESSION_BLOCKS
    else:
        calls = [per_span * B] * SPAN_CALLS
    outs, hops = [], []
    for i, frames in enumerate(calls):
        outs.append(np.asarray(capi.engine_render(h, frames)).reshape(-1, 2))
        err = capi.engine_last_error(h)
        if err:
            raise RuntimeError(f"{path} render latched an error: {err}")
        if path == "span" or (i + 1) % per_span == 0:
            hops.append([
                (ch.cursor,
                 getattr(ch._stretcher, "cur_start_v", np.nan)
                 if ch._stretcher is not None else np.nan)
                for ch in e.mixer.channels])
    capi.engine_free(h)
    return np.concatenate(outs), np.asarray(hops, np.float64)


# --- the headline kit --------------------------------------------------------


def kit_program(n_blocks: int):
    import jax

    from bench_configs import build_full_kit
    from libgooey_tpu.engine import engine as eng

    state, events, static, voices = build_full_kit(n_blocks)
    run = jax.jit(lambda s: eng.render_many(s, events, **static))
    return run, state, voices


def compile_kit():
    """AOT-compile the headline kit (run in a thread, beside the product
    phase).  Returns ``(compiled, state, voices, compile seconds)``."""
    t0 = time.perf_counter()
    run, state, voices = kit_program(KIT_BLOCKS)
    compiled = run.lower(state).compile()
    return compiled, state, voices, time.perf_counter() - t0


# --- the CPU reference -------------------------------------------------------


def cpu_reference(outdir: str) -> None:
    """Child-process body: the CPU renders the comparison targets."""
    import jax

    assert jax.devices()[0].platform == "cpu"
    for path in ("block", "span"):
        audio, hops = render_session(open_session(), path)
        np.save(os.path.join(outdir, f"product_{path}.npy"), audio)
        np.save(os.path.join(outdir, f"hops_{path}.npy"), hops)
    run, state, _ = kit_program(KIT_CHECK_BLOCKS)
    _, blocks = run(state)
    np.save(os.path.join(outdir, "kit.npy"), np.asarray(blocks))
    with open(os.path.join(outdir, "done"), "w") as f:
        f.write("ok")


def start_cpu_reference(outdir: str) -> subprocess.Popen:
    env = dict(os.environ)
    env.update(JAX_PLATFORMS="cpu", CUDA_VISIBLE_DEVICES="",
               JAX_ENABLE_COMPILATION_CACHE="false")
    return subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--cpu-reference", outdir],
        cwd=ROOT, env=env)


def wait_cpu_reference(proc, outdir: str, name: str):
    if not os.path.exists(os.path.join(outdir, "done")):
        rc = proc.wait(timeout=900)
        if rc != 0:
            raise RuntimeError(f"CPU reference failed (rc={rc})")
    return np.load(os.path.join(outdir, name))


# --- phases -----------------------------------------------------------------


def _median_ms(fn, n: int):
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        ts.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(ts))


def phase_product(ref, pool):
    # the span session renders in a worker thread beside the per-block one,
    # so their compiles overlap; each session is built on this thread
    sessions = {path: open_session() for path in ("block", "span")}
    span = pool.submit(render_session, sessions["span"], "span")
    results = {"block": render_session(sessions["block"], "block"),
               "span": span.result()}
    for path, (audio, hops) in results.items():
        if not np.all(np.isfinite(audio)):
            raise AssertionError(f"{path}: non-finite output")
        peak = float(np.abs(audio).max())
        if peak < 1e-3:
            raise AssertionError(f"{path}: silent output (peak {peak})")
        want = ref(f"product_{path}.npy")
        want_hops = ref(f"hops_{path}.npy")
        err = float(np.abs(audio - want).max())
        print(f"  product/{path}: {audio.shape[0]} frames, peak {peak:.4f}, "
              f"max |gpu - cpu| {err:.3g} (bar {TOL})", flush=True)
        if err > TOL:
            raise AssertionError(f"{path}: {err} > {TOL} against the CPU")
        if not np.array_equal(hops[:, :2], want_hops[:, :2]):
            raise AssertionError(
                f"{path}: PreservePitch hop starts differ from the CPU:\n"
                f"{hops[:, :2]}\n{want_hops[:, :2]}")
        print(f"  product/{path}: {len(hops)} hop checkpoints of the 2 "
              f"PreservePitch channels identical to the CPU", flush=True)


def phase_kit(ref, card, kit, ab: bool):
    import jax

    compiled, state, voices, compile_s = kit.result()
    print(f"  kit: compiled in {compile_s:.1f} s (beside the product "
          f"phase); memory_analysis {compiled.memory_analysis()}",
          flush=True)
    _, blocks = compiled(state)
    blocks = np.asarray(blocks)
    if not np.all(np.isfinite(blocks)):
        raise AssertionError("kit: non-finite output")
    want = ref("kit.npy")
    err = float(np.abs(blocks[:KIT_CHECK_BLOCKS] - want).max())
    print(f"  kit: {voices} voices, first {KIT_CHECK_BLOCKS} blocks "
          f"max |gpu - cpu| {err:.3g} (bar {TOL}), peak "
          f"{float(np.abs(blocks).max()):.4f}", flush=True)
    if err > TOL:
        raise AssertionError(f"kit: {err} > {TOL} against the CPU")
    ms = _median_ms(lambda: jax.block_until_ready(compiled(state)), 5)
    print(f"  kit on {card}: {ms / KIT_BLOCKS:.4f} ms per block with the "
          f"recurrence kernel (median of 5 calls of {KIT_BLOCKS} blocks; "
          f"information, not a benchmark)", flush=True)
    if not ab:
        return

    # A/B: the same program with every recurrence on lax.scan
    from libgooey_tpu.ops import recurrence

    default_impl = recurrence.default_impl
    recurrence.default_impl = lambda platform=None: "scan"
    try:
        jax.clear_caches()
        compiled, state, _, _ = compile_kit()
        jax.block_until_ready(compiled(state))
        ms_scan = _median_ms(
            lambda: jax.block_until_ready(compiled(state)), 5)
    finally:
        recurrence.default_impl = default_impl
    print(f"  kit on {card}: {ms_scan / KIT_BLOCKS:.4f} ms per block with "
          f"lax.scan recurrences (same method)", flush=True)


def _kernel_cases(rng):
    """(name, step_fn, carry, xs) at the widths the product runs."""
    import functools

    import jax.numpy as jnp

    from libgooey_tpu.effects import compressor, feedback_waveshaper, lowpass
    from libgooey_tpu.ops import filters
    from libgooey_tpu.ops import scan as gscan

    def biquad_bank(lanes, q):
        freq = rng.uniform(60.0, 4000.0, lanes).astype(np.float32)
        b0, _b1, b2, a1, a2 = filters.rbj_bandpass_coeffs(
            jnp.asarray(freq), q, 1.0, SR)
        n = lambda v: jnp.broadcast_to(jnp.asarray(v)[None, :], (B, lanes))
        x = jnp.asarray(rng.standard_normal((B, lanes)).astype(np.float32))
        w = n(b0) * x
        z = jnp.zeros((B, lanes), jnp.float32)
        carry = (jnp.zeros(lanes, jnp.float32),) * 2
        return carry, (n(-a1), n(-a2), z + 1.0, z, w, z)

    stereo = (2, 4 * B)
    x2 = rng.uniform(-0.9, 0.9, stereo[::-1]).astype(np.float32)
    att, rel = feedback_waveshaper.env_coeffs(SR)
    cases = [
        ("linrec2 biquad [1024 x 512]", gscan.linrec2_step,
         *biquad_bank(1024, 8.0)),
        ("linrec2 membrane [2560 x 512]", gscan.linrec2_step,
         *biquad_bank(2560, 100.0)),
        ("env follower [1024 x 512]",
         functools.partial(feedback_waveshaper.env_follow_step,
                           att=att, rel=rel),
         jnp.zeros(1024, jnp.float32),
         (jnp.asarray(np.abs(rng.standard_normal((B, 1024)))
                      .astype(np.float32)),
          jnp.asarray(rng.random((B, 1024)) < 0.05))),
        ("ladder lowpass [2 x 2048]", lowpass.ladder_step,
         (jnp.zeros(2, jnp.float32),) * 2,
         (jnp.asarray(x2), jnp.full(stereo[::-1], 0.3, jnp.float32),
          jnp.full(stereo[::-1], 2.5, jnp.float32))),
        ("compressor detector [2 x 2048]", compressor.detector_step,
         jnp.zeros(2, jnp.float32),
         (jnp.asarray(np.abs(x2)), jnp.full(stereo[::-1], 0.99, jnp.float32),
          jnp.full(stereo[::-1], 0.9995, jnp.float32),
          jnp.zeros(stereo[::-1], bool))),
    ]
    return cases


def phase_kernels(card):
    import jax
    import jax.numpy as jnp

    from libgooey_tpu.ops import recurrence
    from libgooey_tpu.ops import scan as gscan

    rng = np.random.default_rng(1)
    print(f"  kernels on {card}: f32, kernel vs lax.scan, bar {TOL} abs",
          flush=True)
    for name, step, carry, xs in _kernel_cases(rng):
        runs = {
            impl: jax.jit(lambda c, x, impl=impl: recurrence.sequential_scan(
                step, c, x, impl=impl))
            for impl in ("kernel", "scan")
        }
        got = runs["kernel"](carry, xs)
        want = runs["scan"](carry, xs)
        err = max(float(np.abs(np.asarray(a) - np.asarray(b)).max())
                  for a, b in zip(jax.tree_util.tree_leaves(got),
                                  jax.tree_util.tree_leaves(want)))
        if not err <= TOL:
            raise AssertionError(f"{name}: kernel vs scan {err} > {TOL}")
        times = {impl: _median_ms(
            lambda f=f: jax.block_until_ready(f(carry, xs)), 20)
            for impl, f in runs.items()}
        line = (f"  {name}: max |kernel - scan| {err:.3g}; kernel "
                f"{times['kernel']:.4f} ms, lax.scan {times['scan']:.4f} ms")
        if step is gscan.linrec2_step:
            zeros = jnp.zeros(xs[0].shape[1], jnp.float32)
            assoc = jax.jit(lambda x: gscan.linrec2(
                *[v.T for v in x], (zeros, zeros), impl="assoc"))
            jax.block_until_ready(assoc(xs))
            t = _median_ms(lambda: jax.block_until_ready(assoc(xs)), 20)
            line += f", associative_scan {t:.4f} ms"
        print(line, flush=True)


def run_phase(name, fn, *args):
    c0, t0 = _COMPILE_S[0], time.perf_counter()
    fn(*args)
    print(f"phase {name}: ok, wall {time.perf_counter() - t0:.1f} s, "
          f"compile {_COMPILE_S[0] - c0:.1f} s", flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", choices=PHASES, help="run one phase")
    ap.add_argument("--kit-ab", action="store_true",
                    help="also time the kit with lax.scan recurrences")
    ap.add_argument("--cpu-reference", metavar="DIR", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    if args.cpu_reference:
        cpu_reference(args.cpu_reference)
        return

    import jax
    import jax.monitoring

    from bench import require_gpu
    from cache_dirs import use_compile_cache

    t0 = time.perf_counter()
    devs = require_gpu(jax)
    use_compile_cache()
    jax.monitoring.register_event_duration_secs_listener(_count_compile)
    card = card_line()
    print(f"phase device: ok, wall {time.perf_counter() - t0:.1f} s, "
          f"compile 0.0 s; {devs[0].device_kind} x{len(devs)}", flush=True)

    phases = (args.only,) if args.only else PHASES
    need_ref = any(p in ("product", "kit") for p in phases)
    with tempfile.TemporaryDirectory() as outdir, \
            concurrent.futures.ThreadPoolExecutor(max_workers=2) as pool:
        proc = start_cpu_reference(outdir) if need_ref else None
        ref = lambda name: wait_cpu_reference(proc, outdir, name)
        try:
            kit = pool.submit(compile_kit) if "kit" in phases else None
            if "product" in phases:
                run_phase("product", phase_product, ref, pool)
            if "kit" in phases:
                run_phase("kit", phase_kit, ref, card, kit, args.kit_ab)
            if "kernels" in phases:
                run_phase("kernels", phase_kernels, card)
        finally:
            if proc is not None and proc.poll() is None:
                proc.kill()
                proc.wait()

    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))


if __name__ == "__main__":
    main()
