"""Multi-device voice sharding: the sharded render must match the
single-device render (8 virtual CPU devices, conftest sets the flag)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from libgooey_tpu.core.smoother import smoothing_coeff
from libgooey_tpu.engine import engine as eng
from libgooey_tpu.instruments import kick as kick_mod
from libgooey_tpu.core.smoother import SmootherBank
from libgooey_tpu.parallel import mesh as pmesh

SR, B = 44100.0, 256


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")
@pytest.mark.slow
def test_sharded_render_matches_single_device():
    V = 64  # 8 voices per device
    state = {
        "kick": kick_mod.init_state(V, kick_mod.KickConfig.punch_preset()),
        "pan": SmootherBank.init(np.linspace(0.1, 0.9, V).astype(np.float32)),
        "gain": SmootherBank.init(np.full(V, 1.0 / V, np.float32)),
        "master": SmootherBank.init(np.float32(0.5)),
    }
    offs = np.random.RandomState(0).randint(0, B, V).astype(np.int32)
    vels = np.random.RandomState(1).uniform(0.3, 1.0, V).astype(np.float32)
    static = dict(
        kinds=("kick",), sample_rate=SR, block_size=B,
        smooth_coeff=smoothing_coeff(SR), limiter_threshold=1.0,
        family_static=(("kick", (("feedback_path", False),
                                 ("max_harmonics", 0))),),
    )

    def run(st, off, vel):
        events = {"kick_off": off, "kick_vel": vel,
                  "block_start": np.int32(0)}
        outs = []
        for i in range(3):
            events = dict(events, block_start=np.int32(i * B))
            if i > 0:
                events["kick_off"] = np.full(V, B, np.int32)
                events["kick_vel"] = np.zeros(V, np.float32)
            st, out, mono = eng._render_all_jit(
                st, {k: jax.numpy.asarray(v) for k, v in events.items()},
                **static)
            outs.append(np.asarray(out))
        return np.concatenate(outs, axis=-1)

    ref = run(state, offs, vels)

    mesh = pmesh.make_mesh(8)
    vspec = NamedSharding(mesh, P(pmesh.VOICE_AXIS))
    st_sharded = pmesh.shard_voice_tree(state, mesh)
    offs_s = jax.device_put(offs, vspec)
    vels_s = jax.device_put(vels, vspec)
    got = run(st_sharded, offs_s, vels_s)

    # identical math, different reduction layout → f32 reassociation only
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    assert np.abs(ref).max() > 1e-3


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")
@pytest.mark.slow
def test_sharded_full_kit_bus_matches_single_device():
    """Every trig-latch-heavy family (incl. hihat2/tom2) sharded over the
    mesh, with a replicated bus chain applied after the psum mix."""
    from libgooey_tpu.effects import lowpass as fx_lowpass
    from libgooey_tpu.effects import saturation as fx_saturation

    per_family = {"kick": 8, "snare": 8, "hihat2": 8, "tom2": 8, "bass": 8}
    V = sum(per_family.values())
    state = {}
    for kind, vk in per_family.items():
        state[kind] = eng.FAMILIES[kind].init_state(vk)
    state["pan"] = SmootherBank.init(np.linspace(0.2, 0.8, V).astype(np.float32))
    state["gain"] = SmootherBank.init(np.full(V, 1.0 / V, np.float32))
    state["master"] = SmootherBank.init(np.float32(0.5))
    state["fx_saturation"] = fx_saturation.init_state(SR)
    state["fx_lowpass"] = fx_lowpass.init_state(SR)

    rng = np.random.RandomState(7)
    static = dict(
        kinds=tuple(per_family.keys()), sample_rate=SR, block_size=B,
        smooth_coeff=smoothing_coeff(SR), limiter_threshold=1.0,
        family_static=(("kick", (("feedback_path", False),
                                 ("max_harmonics", 16))),
                       ("snare", (("max_harmonics", 16),))),
        fx_order=("saturation", "lowpass"),
    )

    def make_events(i):
        ev = {"block_start": np.int32(i * B),
              "fx_saturation": jnp.asarray([0.4, 0.3, 1.0], jnp.float32),
              "fx_lowpass": jnp.asarray([6000.0, 0.2], jnp.float32)}
        for kind, vk in per_family.items():
            if i == 0:
                ev[kind + "_off"] = rng.randint(0, B, vk).astype(np.int32)
                ev[kind + "_vel"] = rng.uniform(0.3, 1.0, vk).astype(np.float32)
            else:
                ev[kind + "_off"] = np.full(vk, B, np.int32)
                ev[kind + "_vel"] = np.zeros(vk, np.float32)
        return ev

    events = [make_events(i) for i in range(3)]

    def run(st, shard=None):
        outs = []
        for ev in events:
            ev = {k: jnp.asarray(v) for k, v in ev.items()}
            if shard is not None:
                vspec, rep = shard
                for k in list(ev):
                    if ev[k].ndim == 1 and ev[k].shape[0] % 8 == 0:
                        ev[k] = jax.device_put(ev[k], vspec)
            st, out, _ = eng._render_all_jit(st, ev, **static)
            outs.append(np.asarray(out))
        return np.concatenate(outs, axis=-1)

    ref = run(state)

    mesh = pmesh.make_mesh(8)
    vspec = NamedSharding(mesh, P(pmesh.VOICE_AXIS))
    rep = NamedSharding(mesh, P())
    st_sharded = pmesh.shard_voice_tree(state, mesh)
    got = run(st_sharded, shard=(vspec, rep))

    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-6)
    assert np.abs(ref).max() > 1e-3


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")
@pytest.mark.slow
def test_shard_map_keeps_fused_banks():
    """The shard_map path (parallel.mesh.render_all_sharded) runs the
    instrument banks per shard and must match the unsharded render to
    reduction-order tolerance."""
    per_family = {"kick": 16, "snare": 16, "hihat2": 16, "bass": 16}
    V = sum(per_family.values())
    state = {}
    for kind, vk in per_family.items():
        state[kind] = eng.FAMILIES[kind].init_state(vk)
    state["pan"] = SmootherBank.init(np.linspace(0.2, 0.8, V).astype(np.float32))
    state["gain"] = SmootherBank.init(np.full(V, 1.0 / V, np.float32))
    state["master"] = SmootherBank.init(np.float32(0.5))

    rng = np.random.RandomState(11)
    events = {"block_start": jnp.asarray(np.int32(0))}
    for kind, vk in per_family.items():
        events[kind + "_off"] = jnp.asarray(
            rng.randint(0, B, vk).astype(np.int32))
        events[kind + "_vel"] = jnp.asarray(
            rng.uniform(0.3, 1.0, vk).astype(np.float32))

    static = dict(
        kinds=tuple(per_family.keys()), sample_rate=SR, block_size=B,
        smooth_coeff=smoothing_coeff(SR), limiter_threshold=1.0,
        family_static=(("kick", (("feedback_path", False),
                                 ("max_harmonics", 16))),
                       ("snare", (("max_harmonics", 16),))),
    )

    ref_state, ref_out, ref_mono = eng._render_all_jit(state, events, **static)
    ref_out = np.asarray(ref_out)

    mesh = pmesh.make_mesh(8)
    st_sharded = pmesh.shard_voice_tree(state, mesh)
    ev_sharded = pmesh.shard_voice_tree(events, mesh)
    new_state, out, mono = pmesh.render_all_sharded(
        st_sharded, ev_sharded, mesh=mesh, **static)
    out = np.asarray(out)

    # identical per-shard math; only the mix reduction order differs
    np.testing.assert_allclose(out, ref_out, rtol=0, atol=1e-6)
    np.testing.assert_allclose(np.asarray(mono), np.asarray(ref_mono),
                               rtol=0, atol=1e-6)
    assert np.abs(ref_out).max() > 1e-3
    # per-voice state stays sharded on the mesh
    kick_shard = new_state["kick"].trig_sample.sharding
    assert kick_shard.is_equivalent_to(
        NamedSharding(mesh, P(pmesh.VOICE_AXIS)),
        new_state["kick"].trig_sample.ndim), kick_shard
    # carried state matches the unsharded render
    np.testing.assert_allclose(
        np.asarray(new_state["kick"].trig_sample),
        np.asarray(ref_state["kick"].trig_sample))


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")
@pytest.mark.slow
def test_sharded_granulator_sampler_match_single_device():
    """Grain/voice lanes shard over the mesh; the (replicated) sample
    arenas are read with sharded per-lane positions; the lane-sum mix is
    the psum seam."""
    from libgooey_tpu.instruments import granulator as gran
    from libgooey_tpu.instruments import sampler as samp

    rng = np.random.RandomState(3)
    buf = rng.randn(4096).astype(np.float32) * 0.3
    G = gran.TOTAL  # 80 lanes -> 10 per device
    gstate = gran.init_state(buf, SR)
    gstate = gstate._replace(
        spawn_sample=jnp.zeros(G, jnp.int32),
        duration=jnp.asarray(rng.uniform(2000, 6000, G).astype(np.float32)),
        src_pos=jnp.asarray(rng.uniform(0, 2048, G).astype(np.float32)),
        step=jnp.asarray(rng.uniform(0.5, 2.0, G).astype(np.float32)),
        shape=jnp.asarray(rng.uniform(0.5, 4.0, G).astype(np.float32)),
        vel=jnp.asarray(rng.uniform(0.3, 1.0, G).astype(np.float32)),
    )
    gev = gran.SpawnEvents.empty()

    @jax.jit
    def grun(gs):
        outs = []
        for i in range(2):
            gs, out = gran.render_block(
                gs, gev, jnp.int32(i * B), sample_rate=SR, block_size=B,
                smooth_coeff=smoothing_coeff(SR))
            outs.append(out)
        return jnp.concatenate(outs, axis=-1)

    ref = np.asarray(grun(gstate))

    mesh = pmesh.make_mesh(8)
    vspec = NamedSharding(mesh, P(pmesh.VOICE_AXIS))
    rep = NamedSharding(mesh, P())

    def shard_gran(gs):
        def place(x):
            x = jnp.asarray(x)
            if x.ndim >= 1 and x.shape[0] == G:
                return jax.device_put(x, vspec)
            return jax.device_put(x, rep)   # buffer/scalars replicated
        return jax.tree_util.tree_map(place, gs)

    got = np.asarray(grun(shard_gran(gstate)))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    assert np.abs(ref).max() > 1e-4

    # --- sampler: 32 stereo voices over an interleaved arena ---------------
    SVO = samp.VOICES
    sstate = samp.init_state(4096)
    arena = rng.randn(4096, 2).astype(np.float32) * 0.3
    sstate = sstate._replace(
        arena=jnp.asarray(arena),
        start_sample=jnp.zeros(SVO, jnp.int32),
        base=jnp.zeros(SVO, jnp.int32),
        frames=jnp.full(SVO, 3000.0, jnp.float32),
        increment=jnp.asarray(rng.uniform(0.5, 2.0, SVO).astype(np.float32)),
        velocity=jnp.asarray(rng.uniform(0.3, 1.0, SVO).astype(np.float32)),
    )
    sev = samp.StartEvents.empty()

    @jax.jit
    def srun(ss):
        outs = []
        for i in range(2):
            ss, out = samp.render_block(
                ss, sev, jnp.int32(i * B), sample_rate=SR, block_size=B)
            outs.append(out)
        return jnp.concatenate(outs, axis=-1)

    sref = np.asarray(srun(sstate))

    def shard_samp(ss):
        def place(x):
            x = jnp.asarray(x)
            if x.ndim >= 1 and x.shape[0] == SVO:
                return jax.device_put(x, vspec)
            return jax.device_put(x, rep)
        return jax.tree_util.tree_map(place, ss)

    sgot = np.asarray(srun(shard_samp(sstate)))
    np.testing.assert_allclose(sgot, sref, rtol=0, atol=1e-6)
    assert np.abs(sref).max() > 1e-5


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")
@pytest.mark.slow
def test_shard_map_full_product_scope():
    """ONE multi-device path carries the whole product: the instrument
    banks + LFO routes + the sidechained compressor + the full
    7-effect bus chain + limiter, all inside one shard_map program, equal
    to the single-device render of the identical config.  Routes/sidechain
    resolve their GLOBAL voice ids per-shard (axis_index row masks); the
    sidechain tap adds one [B] psum to the mix reduction.  Two chained
    blocks pin the carried state.  Reference scope: ffi.rs:1043-1380
    (everything in one render)."""
    per_family = {"kick": 8, "snare": 8, "hihat2": 8, "tom2": 8,
                  "bass": 8}
    V = sum(per_family.values())
    fx_order = ("saturation", "lowpass", "tilt", "delay", "compressor",
                "spring", "plate")
    state = {}
    for kind, vk in per_family.items():
        state[kind] = eng.FAMILIES[kind].init_state(vk)
    state["pan"] = SmootherBank.init(np.linspace(0.2, 0.8, V).astype(np.float32))
    state["gain"] = SmootherBank.init(np.full(V, 1.0 / V, np.float32))
    state["master"] = SmootherBank.init(np.float32(0.5))
    for name in fx_order:
        state["fx_" + name] = eng.FX_MODULES[name].init_state(SR)

    rng = np.random.RandomState(23)
    # routes hit voices on DIFFERENT shards (slot 3 -> shard 1, slot 12 ->
    # shard 6 of the 16-voice families on the 8-device mesh)
    lfo_routes = ((0, "kick", 3, "frequency", 0.8),
                  (1, "snare", 6, "filter_cutoff", 0.6))
    sidechain_voice = 2        # kick slot 2 (family-concat global id)
    static = dict(
        kinds=tuple(per_family.keys()), sample_rate=SR, block_size=B,
        smooth_coeff=smoothing_coeff(SR), limiter_threshold=0.9,
        family_static=(("kick", (("feedback_path", False),
                                 ("max_harmonics", 16))),
                       ("snare", (("max_harmonics", 16),))),
        lfo_routes=lfo_routes, sidechain_voice=sidechain_voice,
        fx_order=fx_order,
    )

    def make_events(i):
        ev = {"block_start": np.int32(i * B)}
        for name in fx_order:
            ev["fx_" + name] = np.asarray(eng.FX_DEFAULT_TARGETS[name],
                                          np.float32)
        for kind, vk in per_family.items():
            if i == 0:
                ev[kind + "_off"] = rng.randint(0, B, vk).astype(np.int32)
                ev[kind + "_vel"] = rng.uniform(0.3, 1.0, vk).astype(np.float32)
            else:
                ev[kind + "_off"] = np.full(vk, B, np.int32)
                ev[kind + "_vel"] = np.zeros(vk, np.float32)
        ev["lfo_phase"] = np.full(8, 0.1 * i, np.float32)
        ev["lfo_inc"] = np.full(8, 2.0 / SR, np.float32)
        ev["lfo_amount"] = np.full(8, 0.9, np.float32)
        ev["lfo_offset"] = np.zeros(8, np.float32)
        return ev

    events = [make_events(i) for i in range(2)]

    st = state
    ref_outs = []
    for ev in events:
        st, out, _ = eng._render_all_jit(
            st, {k: jnp.asarray(v) for k, v in ev.items()}, **static)
        ref_outs.append(np.asarray(out))
    ref_state = st

    mesh = pmesh.make_mesh(8)
    st2 = pmesh.shard_voice_tree(state, mesh)
    got_outs = []
    for ev in events:
        st2, out, _ = pmesh.render_all_sharded(
            st2, {k: jnp.asarray(v) for k, v in ev.items()},
            mesh=mesh, **static)
        got_outs.append(np.asarray(out))

    for ref, got in zip(ref_outs, got_outs):
        np.testing.assert_allclose(got, ref, rtol=0, atol=2e-6)
    assert np.abs(ref_outs[0]).max() > 1e-4
    np.testing.assert_allclose(
        np.asarray(st2["fx_compressor"].gain_smooth if hasattr(
            st2["fx_compressor"], "gain_smooth") else 0.0),
        np.asarray(ref_state["fx_compressor"].gain_smooth if hasattr(
            ref_state["fx_compressor"], "gain_smooth") else 0.0),
        rtol=0, atol=1e-5)
    # routed family state (snare runs the XLA path under routes) matches
    np.testing.assert_allclose(
        np.asarray(st2["snare"].params.current),
        np.asarray(ref_state["snare"].params.current), rtol=0, atol=1e-5)
