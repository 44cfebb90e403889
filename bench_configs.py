#!/usr/bin/env python
"""Per-config benchmarks for BASELINE.json's five validation configs.

Prints one JSON line per config: {"config", "value", "unit"}.  The
headline driver metric stays in bench.py (one line); this script gives
every BASELINE config a measured number on real hardware.

Each config renders N_BLOCKS blocks inside ONE jitted lax.scan (how a
production serving loop would batch blocks) so the dispatch cost
amortizes.  The host-driven GooeyEngine pipeline is reported separately
as blocks-per-dispatch=1.  Needs a GPU; it never falls back to the CPU.
"""

import json
import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from libgooey_tpu.core.smoother import SmootherBank, smoothing_coeff
from libgooey_tpu.engine import engine as eng
from libgooey_tpu.instruments import granulator as gran
from libgooey_tpu.instruments import kick as kick_mod
from libgooey_tpu.instruments import sampler as samp
from libgooey_tpu.mixer import chain as chain_mod

SR = 44100.0
B = 512
N_BLOCKS = 64
COEFF = smoothing_coeff(SR)
def _sync(out):
    """Force completion with a small host read of one output leaf (an
    executable's outputs are ready only when the whole program finished)."""
    leaf = jax.tree_util.tree_leaves(out)[-1]
    np.asarray(leaf).ravel()[-1:]


def timed(fn, *args, iters=10, warmup=2):
    for _ in range(warmup):
        out = fn(*args)
    _sync(out)
    best = float("inf")
    for _ in range(iters):
        t0 = time.perf_counter()
        out = fn(*args)
        _sync(out)
        best = min(best, time.perf_counter() - t0)
    return best


def report(config, audio_seconds, wall, note=""):
    unit = "audio-seconds/sec/chip" + (f" ({note})" if note else "")
    print(json.dumps({
        "config": config,
        "value": round(audio_seconds / wall, 3),
        "unit": unit,
    }))


def _render_many_rtf(voices, config, name, note, pipe: int = 1):
    """Scan N_BLOCKS kick blocks in one dispatch (bench.py's machinery).

    ``pipe`` > 1 chains states through that many dependent calls per sync
    (steady-state pipelined throughput — the r03 headline methodology)."""
    state = {
        "kick": kick_mod.init_state(voices, config),
        "pan": SmootherBank.init(np.full(voices, 0.5, np.float32)),
        "gain": SmootherBank.init(np.full(voices, 1.0 / voices, np.float32)),
        "master": SmootherBank.init(np.float32(0.25)),
    }
    offs = np.full((N_BLOCKS, voices), B, np.int32)
    offs[0, :] = 0
    vels = np.zeros((N_BLOCKS, voices), np.float32)
    vels[0, :] = 1.0
    events = {
        "kick_off": jnp.asarray(offs),
        "kick_vel": jnp.asarray(vels),
        "block_start": jnp.asarray((np.arange(N_BLOCKS) * B).astype(np.int32)),
    }
    static = dict(kinds=("kick",), sample_rate=SR, block_size=B,
                  smooth_coeff=COEFF, limiter_threshold=1.0,
                  family_static=(("kick", (("feedback_path", False),
                                           ("max_harmonics", 0))),))
    run = jax.jit(lambda s: eng.render_many(s, events, **static))
    if pipe > 1:
        def chained():
            s = state
            for _ in range(pipe):
                s, blocks = run(s)
            return blocks
        wall = timed(chained) / pipe
    else:
        wall = timed(run, state)
    report(name, voices * N_BLOCKS * B / SR, wall, note)


def bench_single_kick():
    _render_many_rtf(1, kick_mod.KickConfig.tight(), "single_kick_voice",
                     "1 voice")


def bench_kick_bank_4096():
    """The rounds-1..3 headline config (cheapest family at target scale);
    bench.py now tracks the five-family kit + bus instead."""
    _render_many_rtf(4096, kick_mod.KickConfig.tight(),
                     "kick_bank_4096_voices",
                     "4096 voices, kick only, pipelined", pipe=8)


def bench_full_kit():
    e = eng.Engine(SR)
    for kind in ("kick", "snare", "hihat2", "tom2"):
        e.add_instrument(kind, kind)
        e.trigger(kind, 1.0)
    e._stage()
    events = e._collect_events()
    e._stage()
    stacked = {k: jnp.broadcast_to(v, (N_BLOCKS,) + v.shape)
               for k, v in events.items() if k != "block_start"}
    stacked["block_start"] = jnp.asarray(
        (np.arange(N_BLOCKS) * B).astype(np.int32))
    static = dict(kinds=e.instrument_kinds(), sample_rate=SR, block_size=B,
                  smooth_coeff=e.smooth_coeff, limiter_threshold=1.0,
                  family_static=e._static_key())
    run = jax.jit(lambda s: eng.render_many(s, stacked, **static))
    wall = timed(run, e._state)
    report("full_drum_kit_mix", 4 * N_BLOCKS * B / SR, wall, "4 voices")


def build_full_kit(n_blocks: int, block: int = B, sr: float = SR):
    """State/events/static for BASELINE config-2 at target scale: a
    4,096-voice five-family kit (kick/snare/hihat2/tom2/bass banks) plus
    the full replicated global bus
    (saturation, lowpass, tilt, delay, compressor, spring, plate, pinned
    soft limiter).  Reference pipeline: ffi.rs:1043-1380.  Shared by
    bench.py (the headline metric) and bench_full_kit_4096.

    Returns ``(state, events, static, total_voices)``.
    """
    per_family = {"kick": 1024, "snare": 1024, "hihat2": 1024,
                  "tom2": 512, "bass": 512}
    N_BLOCKS, B, SR = n_blocks, block, sr  # noqa: shadow module constants
    COEFF = smoothing_coeff(SR)
    V = sum(per_family.values())
    state = {}
    for kind, vk in per_family.items():
        state[kind] = eng.FAMILIES[kind].init_state(vk)
    state["pan"] = SmootherBank.init(
        np.linspace(0.2, 0.8, V).astype(np.float32))
    state["gain"] = SmootherBank.init(np.full(V, 1.0 / V, np.float32))
    state["master"] = SmootherBank.init(np.float32(0.25))
    fx_order = ("saturation", "lowpass", "tilt", "delay", "compressor",
                "spring", "plate")
    for name in fx_order:
        state["fx_" + name] = eng.FX_MODULES[name].init_state(SR)

    # staggered sequenced triggers per family (bench.py's event builder)
    from libgooey_tpu.engine.sequencer import Sequencer
    seq = Sequencer(120.0, SR, 16)
    seq.set_pattern([True] * 16)
    seq.start()
    base_hits = []
    done = 0
    for _b in range(N_BLOCKS):
        for t in seq.tick_block(B):
            base_hits.append(done + t.offset)
        done += B
    rng = np.random.RandomState(0)
    events = {"block_start": jnp.asarray(
        (np.arange(N_BLOCKS) * B).astype(np.int32))}
    total = N_BLOCKS * B
    for kind, vk in per_family.items():
        offs = np.full((N_BLOCKS, vk), B, np.int32)
        vels = np.zeros((N_BLOCKS, vk), np.float32)
        lags = rng.randint(0, int(SR * 0.5), size=vk)
        for v in range(vk):
            for h in base_hits:
                s = h + int(lags[v])
                if s < total:
                    offs[s // B, v] = s % B
                    vels[s // B, v] = 0.5 + 0.5 * ((v % 7) / 6.0)
        events[kind + "_off"] = jnp.asarray(offs)
        events[kind + "_vel"] = jnp.asarray(vels)
    for name in fx_order:
        events["fx_" + name] = jnp.broadcast_to(
            jnp.asarray(eng.FX_DEFAULT_TARGETS[name], jnp.float32),
            (N_BLOCKS, len(eng.FX_DEFAULT_TARGETS[name])))

    static = dict(
        kinds=tuple(per_family.keys()),
        sample_rate=SR, block_size=B, smooth_coeff=COEFF,
        limiter_threshold=1.0,
        family_static=(
            ("kick", (("feedback_path", False), ("max_harmonics", 0))),
            ("snare", (("max_harmonics", 64),)),
        ),
        fx_order=fx_order,
    )
    return state, events, static, V


def bench_full_kit_4096():
    """Measure build_full_kit with this script's scanned-dispatch timing."""
    state, events, static, V = build_full_kit(N_BLOCKS)
    run = jax.jit(lambda s: eng.render_many(s, events, **static))
    wall = timed(run, state)
    report("full_kit_4096_voices_plus_bus", V * N_BLOCKS * B / SR, wall,
           f"{V} voices, 5 families, 7-effect bus")


def bench_preserve_pitch_loops():
    """4 loop channels in PreservePitch (WSOLA) at warp 1.5 — the clip-grid
    time-stretch path (wsola.rs:34-37).  Reported for both correlation-
    search implementations: host numpy (reference-mirroring oracle) and
    the on-device fixed-size-einsum search (ops/wsola_search.py)."""
    from libgooey_tpu.mixer import wsola
    from libgooey_tpu.mixer.loop_channel import PITCH_PRESERVE
    from libgooey_tpu.mixer.mixer import Mixer
    from libgooey_tpu.mixer.stereo_buffer import StereoSampleBuffer

    rng = np.random.RandomState(0)
    n = 32

    for dev in (False, True):
        wsola.USE_DEVICE_SEARCH = dev
        try:
            m = Mixer(SR, block_size=B, buffer_capacity=1 << 16)
            m.set_bpm(180.0)  # source 120 -> warp 1.5
            for ch in m.channels:
                tone = (rng.randn(44100) * 0.3).astype(np.float32)
                ch.set_buffer(StereoSampleBuffer.from_channels(
                    tone, tone, SR, 120.0))
                ch.pitch_mode = PITCH_PRESERVE
                ch.set_playing(True)
            m.render_block()  # warm graphs

            def run():
                for _ in range(n):
                    out = m.render_block()
                return out

            wall = timed(run, iters=3, warmup=1) / n
            report(f"preserve_pitch_4loops_{'device' if dev else 'host'}_search",
                   4 * B / SR, wall, "4 WSOLA channels, warp 1.5")
        finally:
            wsola.USE_DEVICE_SEARCH = False

    # device-resident hop scan (ops/wsola_stream.py): the whole WSOLA loop
    # — search, grain reads, overlap-add — runs inside one lax.scan (all 4
    # channels in ONE channel-batched scan since r5), so a K-block batch is
    # ONE dispatch instead of one round trip per hop
    K = 128
    wsola.USE_DEVICE_SEARCH = True
    try:
        m = Mixer(SR, block_size=B, buffer_capacity=1 << 16)
        m.set_bpm(180.0)
        for ch in m.channels:
            tone = (rng.randn(44100) * 0.3).astype(np.float32)
            ch.set_buffer(StereoSampleBuffer.from_channels(
                tone, tone, SR, 120.0))
            ch.pitch_mode = PITCH_PRESERVE
            ch.set_playing(True)
        m.render_blocks(K)  # warm both n_hops variants
        m.render_blocks(K)

        def run():
            return m.render_blocks(K)

        wall = timed(run, iters=5, warmup=1) / K
        report("preserve_pitch_4loops_device_stream", 4 * B / SR, wall,
               f"4 WSOLA channels, warp 1.5, {K}-block batched hop scan")
    finally:
        wsola.USE_DEVICE_SEARCH = False

    # the same 4 channels driven by the CLIP GRID with the transport
    # RUNNING — live session playback, the headline feature WSOLA exists
    # for.  No action is scheduled inside the span, so every channel stays
    # on the batched device scan (stream_config's beat-horizon check)
    wsola.USE_DEVICE_SEARCH = True
    try:
        m = Mixer(SR, block_size=B, buffer_capacity=1 << 16)
        m.set_bpm(180.0)
        for col, ch in enumerate(m.channels):
            tone = (rng.randn(44100) * 0.3).astype(np.float32)
            buf = StereoSampleBuffer.from_channels(tone, tone, SR, 120.0)
            m.clip_grid.load(col, 0, buf, 120.0)
        m.clip_grid.transport_start(m.channels)
        for col in range(4):
            m.clip_grid.launch_at(col, 0, 0.0)
        m.render_blocks(2)  # land the launches, warm graphs
        m.render_blocks(K)
        m.render_blocks(K)

        def run_grid():
            return m.render_blocks(K)

        wall = timed(run_grid, iters=5, warmup=1) / K
        report("preserve_pitch_4loops_running_transport", 4 * B / SR, wall,
               f"4 WSOLA clips under a RUNNING clip-grid transport, "
               f"{K}-block batched hop scan")
    finally:
        wsola.USE_DEVICE_SEARCH = False


def bench_sequenced_submix():
    from libgooey_tpu.gooey import GooeyEngine

    g = GooeyEngine(SR)
    for ch in range(4):
        g.sequencers[ch].set_pattern_string("x.x.x.x.x.x.x.x.")
        g.sequencers[ch].start()
    g.strip_pan[:] = [0.2, 0.4, 0.6, 0.8, 0.5]
    g.strip_mute[3] = True
    g.render(B)  # warm all graphs
    n = 16

    def run():
        for _ in range(n):
            out = g._render_one_block()
        return out

    wall = timed(run, iters=3, warmup=1) / n
    report("sequencer_into_submixes", B / SR, wall,
           "full product pipeline, 1 block/dispatch")

    # the planned-span path: the SAME product pipeline, K blocks per
    # scanned dispatch (gooey._span_render) — how gooey_engine_render
    # actually runs a multi-block host callback / offline render.
    # K=16 is a 186 ms realtime lookahead; K=64 the offline/bounce span.
    for K in (16, 64):
        g.render(K * B)  # warm the span graph
        def run_span(K=K):
            return g.render(K * B)
        wall = timed(run_span, iters=3, warmup=1) / K
        report(f"sequencer_into_submixes_span{K}", B / SR, wall,
               f"full product pipeline, {K} blocks/dispatch (planned span)")


def bench_interactive_pipelined():
    """The interactive realtime story (engine_output.rs:293-311 contract).

    Drives the FULL product pipeline block-by-block like a host callback,
    but pipelined: block N+1 is dispatched before block N is read, so host
    event prep overlaps device compute (render_blocks does the same).  Two
    numbers:

    * on-chip sustained block time — amortized over a pipelined run
      (dispatch all, block_until_ready once): the realtime contract is
      <11.6 ms/block at 44.1 kHz/512;
    * worst-case single-block latency with a depth-1 pipeline (the host
      reads block N-1 right after dispatching N).
    """
    from libgooey_tpu.gooey import GooeyEngine

    g = GooeyEngine(SR)
    for ch in range(4):
        g.sequencers[ch].set_pattern_string("x.x.x.x.x.x.x.x.")
        g.sequencers[ch].set_swing(0.6)
        g.sequencers[ch].start()
    for eid in (chain_mod.EFFECT_SATURATION, chain_mod.EFFECT_DELAY,
                chain_mod.EFFECT_REVERB):
        g.set_effect_enabled(eid, True)
    g.render(4 * B)  # warm every graph in the path
    n = 64

    # sustained: dispatch every block, sync once at the end
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        outs = [g._render_one_block() for _ in range(n)]
        jax.block_until_ready(outs[-1])
        best = min(best, (time.perf_counter() - t0) / n)
    report("interactive_pipelined_sustained", B / SR, best,
           "full product pipeline, pipelined dispatch")

    # worst-case latency, depth-1 pipeline
    prev = g._render_one_block()
    worst = 0.0
    for _ in range(n):
        t0 = time.perf_counter()
        nxt = g._render_one_block()
        np.asarray(prev)
        worst = max(worst, time.perf_counter() - t0)
        prev = nxt
    print(json.dumps({
        "config": "interactive_depth1_worst_block_latency",
        "value": round(worst * 1e3, 3),
        "unit": "ms",
    }))


def _chain_runner(effect_ids):
    chain = chain_mod.EffectChain(SR, 120.0)
    for eid in effect_ids:
        chain.add(eid)
    x = jnp.asarray(
        np.random.RandomState(0).randn(N_BLOCKS, 2, B).astype(np.float32) * 0.3
    )
    targets = tuple(chain.targets_list())
    key = chain.static_key()

    @jax.jit
    def run(states, x):
        def step(st, xb):
            st2, y = chain_mod.process_chain(st, xb, targets, key,
                                             sample_rate=SR)
            return tuple(st2), y

        return jax.lax.scan(step, states, x)

    states = tuple(chain.states)
    return lambda: run(states, x)


def _bench_chain(name, effect_ids):
    """Net of an empty-chain floor probe: the same 64-block dispatch with
    zero effects measures the pure dispatch overhead."""
    run = _chain_runner(effect_ids)
    floor = _chain_runner(())
    wall = timed(lambda: run())
    wall_floor = timed(lambda: floor())
    report(name, N_BLOCKS * B / SR, max(wall - wall_floor, 1e-9),
           "stereo bus, net of empty-chain dispatch floor "
           f"({wall_floor / N_BLOCKS * 1e6:.0f} us/block)")


def bench_effects_chain():
    _bench_chain(
        "fx_chain_delay_reverb_dist_tilt_4x",
        (chain_mod.EFFECT_DELAY, chain_mod.EFFECT_REVERB,
         chain_mod.EFFECT_SATURATION, chain_mod.EFFECT_TILT_FILTER),
    )


def bench_effects_chain_all9():
    """All nine reorderable effects in series (the worst-case master bus)."""
    _bench_chain(
        "fx_chain_all9_4x",
        tuple(range(chain_mod.REORDERABLE_EFFECT_COUNT))
        + (chain_mod.EFFECT_PLATE_REVERB,),
    )


def bench_granulator_sampler_4k():
    # one granulator "mega-instance" with 4,000 grain lanes (the grain state
    # is shape-driven, so the 4k-concurrent-grains config is literally one
    # batched state) + the reference's full sampler capacity (4 racks x 32
    # voices, ffi.rs:585 / sampler.rs:13) = 4,128 lanes total
    G_LANES, RACKS = 4000, 4
    buf = np.random.RandomState(0).randn(1 << 15).astype(np.float32) * 0.3
    base = gran.init_state(buf, SR)
    rng = np.random.RandomState(1)

    def widen(a):
        if a.ndim == 1 and a.shape[0] == gran.TOTAL:
            return jnp.broadcast_to(a[:1], (G_LANES,)).copy() \
                if False else jnp.tile(a, (G_LANES // gran.TOTAL,))
        return a

    gstate = jax.tree_util.tree_map(widen, base)
    # seed every lane as an active long grain
    gstate = gstate._replace(
        spawn_sample=jnp.zeros(G_LANES, jnp.int32),
        duration=jnp.asarray(rng.uniform(20000, 60000, G_LANES).astype(np.float32)),
        src_pos=jnp.asarray(rng.uniform(0, 1 << 14, G_LANES).astype(np.float32)),
        step=jnp.asarray(rng.uniform(0.5, 2.0, G_LANES).astype(np.float32)),
        shape=jnp.asarray(rng.uniform(0.5, 4.0, G_LANES).astype(np.float32)),
        vel=jnp.asarray(rng.uniform(0.3, 1.0, G_LANES).astype(np.float32)),
        rel_start=jnp.full(G_LANES, -1, jnp.int32),
        rel_total=jnp.zeros(G_LANES, jnp.float32),
    )
    gev_empty = gran.SpawnEvents(**{
        k: jnp.asarray(v) for k, v in zip(
            gran.SpawnEvents._fields,
            [np.full(gran.MAX_SPAWNS_PER_BLOCK, -1, np.int32),
             np.zeros(gran.MAX_SPAWNS_PER_BLOCK, np.int32),
             np.ones(gran.MAX_SPAWNS_PER_BLOCK, np.float32),
             np.zeros(gran.MAX_SPAWNS_PER_BLOCK, np.float32),
             np.ones(gran.MAX_SPAWNS_PER_BLOCK, np.float32),
             np.full(gran.MAX_SPAWNS_PER_BLOCK, 2.0, np.float32),
             np.zeros(gran.MAX_SPAWNS_PER_BLOCK, np.float32),
             np.zeros(gran.MAX_SPAWNS_PER_BLOCK, np.float32),
             np.full(gran.MAX_SPAWNS_PER_BLOCK, -1, np.int32)])
    })
    # flatten the racks into ONE sampler state with RACKS*32 voices (the
    # voice arrays are shape-driven; all bench racks share one arena)
    S_VOICES = RACKS * samp.VOICES
    sbase = samp.init_state(1 << 15)
    sstate = sbase._replace(
        start_sample=jnp.zeros(S_VOICES, jnp.int32),
        base=jnp.zeros(S_VOICES, jnp.int32),
        frames=jnp.full(S_VOICES, 30000.0, jnp.float32),
        increment=jnp.asarray(rng.uniform(0.5, 2.0, S_VOICES).astype(np.float32)),
        velocity=jnp.asarray(rng.uniform(0.3, 1.0, S_VOICES).astype(np.float32)),
    )
    KS = samp.MAX_STARTS_PER_BLOCK
    sev_empty = samp.StartEvents.empty()

    @jax.jit
    def run(gs, ss):
        def step(carry, i):
            gs, ss = carry
            gs2, gout = gran.render_block(
                gs, gev_empty, jnp.int32(i * B), sample_rate=SR, block_size=B,
                smooth_coeff=COEFF)
            ss2, sout = samp.render_block(
                ss, sev_empty, jnp.int32(i * B), sample_rate=SR, block_size=B,
)
            return (gs2, ss2), gout + sout[0]

        return jax.lax.scan(step, (gs, ss), jnp.arange(N_BLOCKS))

    wall = timed(lambda g, s: run(g, s), gstate, sstate)
    lanes = G_LANES + S_VOICES
    report("granulator_lfo_sampler_4k_lanes", lanes * N_BLOCKS * B / SR, wall,
           f"{lanes} lanes")


def bench_onchip_product_block():
    """The realtime contract: one composed device step =
    the full 64-voice kit banks (kick/snare/hihat2/tom2/bass, as
    __graft_entry__.entry) feeding the full 10-effect bus chain, scanned
    N_BLOCKS per dispatch so the per-block figure measures device compute
    only.  engine_output.rs:293-311's contract is wall-time <= 11.61 ms
    per 512-sample block."""
    import __graft_entry__ as ge

    fn, (kstate, kevents) = ge.entry()
    chain = chain_mod.EffectChain(SR, 120.0)
    for eid in range(chain_mod.REORDERABLE_EFFECT_COUNT):
        chain.add(eid)
    chain.add(chain_mod.EFFECT_PLATE_REVERB)
    targets = tuple(chain.targets_list())
    key = chain.static_key()
    kev = {k: jnp.asarray(v) for k, v in kevents.items()}

    @jax.jit
    def run(ks, cs):
        def step(carry, i):
            ks, cs = carry
            ev = dict(kev, block_start=jnp.int32(i) * B)
            ks2, out = fn(ks, ev)
            cs2, y = chain_mod.process_chain(cs, out, targets, key,
                                             sample_rate=SR)
            return (ks2, tuple(cs2)), y[:, -1]

        return jax.lax.scan(step, (ks, cs), jnp.arange(N_BLOCKS))

    wall = timed(lambda a, b: run(a, b), kstate, tuple(chain.states))
    us = wall / N_BLOCKS * 1e6
    print(json.dumps({
        "config": "onchip_product_block_64v_kit_plus_all10_bus",
        "value": round(us, 1),
        "unit": f"us/block device compute (budget 11610 us; "
                f"{round(11610.0 / us, 1)}x headroom)",
    }))


def main():
    from bench import require_gpu
    from cache_dirs import use_compile_cache

    dev = require_gpu(jax)[0]
    use_compile_cache()
    print(f"# device: {dev.platform} {dev.device_kind}", file=sys.stderr)
    bench_single_kick()
    bench_kick_bank_4096()
    bench_full_kit()
    bench_full_kit_4096()
    bench_effects_chain()
    bench_effects_chain_all9()
    bench_granulator_sampler_4k()
    bench_preserve_pitch_loops()
    bench_sequenced_submix()
    bench_interactive_pipelined()
    bench_onchip_product_block()


if __name__ == "__main__":
    main()
