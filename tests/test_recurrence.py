"""The sequential-recurrence kernel (ops/recurrence.py) and its routing.

On the CPU the kernel runs through the Pallas interpreter.  Each case runs
a public function twice — routed to the kernel, and on its ``lax.scan``
reference — and requires the same samples; the oracle cases hold the
kernel to per-sample numpy loops.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from libgooey_tpu.effects import compressor, delay, lowpass, tilt
from libgooey_tpu.effects import feedback_waveshaper as fbws
from libgooey_tpu.ops import filters, recurrence
from libgooey_tpu.ops import scan as gscan

SR = 44100.0


def _route_to_kernel(monkeypatch):
    """Every sequential recurrence through the interpreted kernel."""
    run = recurrence.sequential_scan
    monkeypatch.setattr(
        recurrence, "sequential_scan",
        lambda f, c, x, impl=None: run(f, c, x, impl="kernel", interpret=True))


def _both(monkeypatch, fn):
    """``fn()`` on the lax.scan reference, then through the kernel."""
    want = jax.tree_util.tree_leaves(fn())
    _route_to_kernel(monkeypatch)
    got = jax.tree_util.tree_leaves(fn())
    return got, want


def _assert_same(got, want, atol=1e-6):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w),
                                   rtol=0, atol=atol)


# --- kernel vs lax.scan: {recurrence} x {lanes} x {B} ------------------------


def _case(name, lanes, B, rng):
    x = rng.standard_normal((lanes, B)).astype(np.float32)
    reset = jnp.asarray(rng.random((lanes, B)) < 0.01)
    zeros = jnp.zeros(lanes, jnp.float32)
    if name == "biquad_linrec2":
        freq = rng.uniform(80.0, 5000.0, (lanes, 1)).astype(np.float32)
        coeffs = filters.rbj_bandpass_coeffs(jnp.asarray(freq), 30.0, 1.0, SR)
        st = filters.BiquadState.init((lanes,))
        return lambda: filters.biquad_df1_block(
            st, jnp.asarray(x), coeffs, reset=reset)
    if name == "svf_reset":
        cut = (200.0 + 8000.0 * rng.random((lanes, B))).astype(np.float32)
        g, h = filters.svf_coeffs(jnp.asarray(cut), 0.9, SR)
        ic = jnp.asarray(rng.standard_normal(lanes).astype(np.float32) * 0.1)
        return lambda: filters.svf_tpt_block(
            filters.SVFState(ic, ic), jnp.asarray(x), g, h, reset=reset)
    if name == "env_follower":
        att, rel = fbws.env_coeffs(SR)
        frz = jnp.asarray(rng.random((lanes, B)) < 0.1)
        return lambda: fbws._env_follow(
            zeros, jnp.asarray(np.abs(x)), att, rel, frz)
    if name == "ladder_lowpass":
        g = rng.uniform(0.05, 0.9, (lanes, B)).astype(np.float32)
        fb = rng.uniform(0.0, 3.3, (lanes, B)).astype(np.float32)
        return lambda: gscan.nonlinear_scan(
            lowpass.ladder_step, (zeros, zeros),
            (jnp.asarray(x), jnp.asarray(g), jnp.asarray(fb)))
    if name == "compressor_detector":
        ac = np.full((lanes, B), 0.99, np.float32)
        rc = np.full((lanes, B), 0.9995, np.float32)
        byp = jnp.asarray(rng.random((lanes, B)) < 0.05)
        return lambda: gscan.nonlinear_scan(
            compressor.detector_step, zeros,
            (jnp.asarray(np.abs(x)), jnp.asarray(ac), jnp.asarray(rc), byp))
    raise KeyError(name)


@pytest.mark.parametrize("B", [512, 2048])
@pytest.mark.parametrize("lanes", [37, 2], ids=["lanes37", "stereo"])
@pytest.mark.parametrize("name", [
    "biquad_linrec2", "svf_reset", "env_follower", "ladder_lowpass",
    "compressor_detector"])
def test_kernel_matches_scan(monkeypatch, name, lanes, B):
    fn = _case(name, lanes, B, np.random.default_rng(lanes * B))
    got, want = _both(monkeypatch, fn)
    _assert_same(got, want)


def _fx_block(mod, init_args, targets, **kw):
    rng = np.random.default_rng(7)
    x = jnp.asarray(rng.uniform(-0.9, 0.9, (2, 512)).astype(np.float32))

    def run():
        st = mod.init_state(SR, *init_args)
        outs = []
        for _ in range(2):
            st, y = mod.process_block(st, x, np.asarray(targets, np.float32),
                                      sample_rate=SR, **kw)
            outs.append(y)
        return st, outs
    return run


def _fbws_general():
    rng = np.random.default_rng(9)
    x = jnp.asarray(rng.uniform(-0.9, 0.9, (2, 512)).astype(np.float32))

    def run():
        return fbws.process_block(
            fbws.FBShaperState.init((2,)), x, jnp.float32(6.0),
            jnp.float32(0.6), fbws.filter_coeff(2000.0, SR), jnp.float32(0.7),
            SR, feedback_path=True)
    return run


def _membrane():
    rng = np.random.default_rng(11)
    x = jnp.asarray(rng.standard_normal((6, 512)).astype(np.float32) * 0.1)
    q = jnp.linspace(0.005, 0.02, 6)

    def run():
        return filters.membrane_block(
            filters.MembraneState.init((6,)), x, q, jnp.full(6, 0.003), SR)
    return run


@pytest.mark.parametrize("case", [
    "lowpass", "compressor", "tilt", "delay", "feedback_waveshaper",
    "membrane"])
def test_effect_through_kernel_matches_scan(monkeypatch, case):
    fn = {
        "lowpass": lambda: _fx_block(lowpass, (2000.0, 0.8), (2000.0, 0.8)),
        "compressor": lambda: _fx_block(
            compressor, (-30.0, 8.0, 1.0, 50.0, 1.0),
            (-30.0, 8.0, 1.0, 50.0, 1.0)),
        "tilt": lambda: _fx_block(tilt, (0.2, 0.7), (0.2, 0.7)),
        "delay": lambda: _fx_block(
            delay, (0.005, 0.6, 0.8, 3000.0), (0.005, 0.6, 0.8, 3000.0)),
        "feedback_waveshaper": _fbws_general,
        "membrane": _membrane,
    }[case]()
    got, want = _both(monkeypatch, fn)
    _assert_same(got, want)


# --- per-sample oracles, pointed at the kernel -------------------------------


def test_linrec2_kernel_matches_per_sample_oracle(monkeypatch):
    """Biquad-shaped 2-state recurrence through the kernel vs a numpy loop
    in the same per-sample op order."""
    _route_to_kernel(monkeypatch)
    rs = np.random.RandomState(11)
    V, B = 5, 512
    a1 = (-1.2 + 0.1 * rs.rand(V, B)).astype(np.float32)
    a2 = (0.5 + 0.1 * rs.rand(V, B)).astype(np.float32)
    w = rs.randn(V, B).astype(np.float32)
    s10 = (rs.randn(V) * 0.1).astype(np.float32)
    s20 = (rs.randn(V) * 0.1).astype(np.float32)
    ones, zeros = np.ones((V, B), np.float32), np.zeros((V, B), np.float32)
    s1k, _ = gscan.linrec2(-a1, -a2, ones, zeros, w, zeros, (s10, s20))

    s1o, s2o = s10.copy(), s20.copy()
    ref = np.zeros((V, B), np.float32)
    for n in range(B):
        n1 = (-a1[:, n] * s1o + -a2[:, n] * s2o + w[:, n]).astype(np.float32)
        ref[:, n] = n1
        s1o, s2o = n1, s1o
    # same op order; a compiler may contract to FMA -> ulp-level noise
    np.testing.assert_allclose(np.asarray(s1k), ref, rtol=1e-5, atol=1e-5)


def test_svf_kernel_matches_per_sample_oracle(monkeypatch):
    """TPT SVF with per-sample coefficients and trigger resets through the
    kernel vs the reference's per-sample update (resonant_lowpass.rs:48-61)."""
    _route_to_kernel(monkeypatch)
    rs = np.random.RandomState(12)
    V, B = 2 * 32 + 40, 512
    x = rs.randn(V, B).astype(np.float32)
    cut = (200 + 8000 * rs.rand(V, B)).astype(np.float32)
    g, h = (np.asarray(v) for v in filters.svf_coeffs(jnp.asarray(cut), 0.9, SR))
    reset = rs.rand(V, B) < 0.01
    ic0 = (rs.randn(V) * 0.1).astype(np.float32)
    st, _v1, v2 = filters.svf_tpt_block(
        filters.SVFState(jnp.asarray(ic0), jnp.asarray(ic0)), jnp.asarray(x),
        jnp.asarray(g), jnp.asarray(h), reset=jnp.asarray(reset))

    ic1, ic2 = ic0.copy(), ic0.copy()
    v2o = np.zeros((V, B), np.float32)
    for n in range(B):
        ic1 = np.where(reset[:, n], 0.0, ic1).astype(np.float32)
        ic2 = np.where(reset[:, n], 0.0, ic2).astype(np.float32)
        v1 = ((g[:, n] * (x[:, n] - ic2) + ic1) * h[:, n]).astype(np.float32)
        v2n = (ic2 + g[:, n] * v1).astype(np.float32)
        v2o[:, n] = v2n
        ic1 = (2 * v1 - ic1).astype(np.float32)
        ic2 = (2 * v2n - ic2).astype(np.float32)
    # the recurrence runs in state-affine form (filters.svf_tpt_block), the
    # oracle in the reference's update order
    np.testing.assert_allclose(np.asarray(v2), v2o, atol=2e-5)
    np.testing.assert_allclose(np.asarray(st.ic2), ic2, atol=2e-5)


# --- routing ------------------------------------------------------------------


@pytest.mark.parametrize("platform,impl", [("gpu", "kernel"), ("cpu", "scan")])
def test_default_impl_by_platform(platform, impl):
    assert recurrence.default_impl(platform) == impl


def _primitives(jaxpr):
    """Every equation of a jaxpr, nested jaxprs included (kernel bodies
    excepted)."""
    for eqn in jaxpr.eqns:
        yield eqn
        if eqn.primitive.name == "pallas_call":
            continue
        for v in eqn.params.values():
            for sub in (v if isinstance(v, (list, tuple)) else (v,)):
                inner = getattr(sub, "jaxpr", sub)
                if hasattr(inner, "eqns"):
                    yield from _primitives(inner)


def _linrec2_call():
    a = jnp.full((3, 64), 0.5, jnp.float32)
    return lambda: gscan.linrec2(a, a * 0, a * 0, a, a, a,
                                 (jnp.zeros(3), jnp.zeros(3)))


def _nonlinear_call():
    x = jnp.ones((2, 64), jnp.float32)
    return lambda: gscan.nonlinear_scan(
        lowpass.ladder_step, (jnp.zeros(2), jnp.zeros(2)), (x, x * 0.3, x))


@pytest.mark.parametrize("call", [_linrec2_call, _nonlinear_call],
                         ids=["linrec2", "nonlinear_scan"])
def test_gpu_routes_to_compiled_kernel(monkeypatch, call):
    """On a GPU the recurrence is one pallas_call through Triton, never the
    interpreter (the jaxpr is traced here; nothing is lowered)."""
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    eqns = list(_primitives(jax.make_jaxpr(call())().jaxpr))
    calls = [e for e in eqns if e.primitive.name == "pallas_call"]
    assert len(calls) == 1
    assert calls[0].params["interpret"] is False
    assert calls[0].params["backend"] == "triton"
    assert not any(e.primitive.name == "scan" for e in eqns)


def test_cpu_routes_to_lax_scan():
    eqns = list(_primitives(jax.make_jaxpr(_linrec2_call())().jaxpr))
    assert any(e.primitive.name == "scan" for e in eqns)
    assert not any(e.primitive.name == "pallas_call" for e in eqns)


# --- contraction precision (a GPU may run DEFAULT f32 dots in TF32) -----------


def _kit(V=2):
    from libgooey_tpu.core.smoother import SmootherBank, smoothing_coeff
    from libgooey_tpu.engine import engine as eng

    kinds = ("kick", "snare")
    state = {k: eng.FAMILIES[k].init_state(V) for k in kinds}
    state["pan"] = SmootherBank.init(np.full(2 * V, 0.5, np.float32))
    state["gain"] = SmootherBank.init(np.full(2 * V, 0.5, np.float32))
    state["master"] = SmootherBank.init(np.float32(0.5))
    state["fx_compressor"] = eng.FX_MODULES["compressor"].init_state(SR)
    events = {"block_start": np.int32(0),
              "fx_compressor": np.asarray(eng.FX_DEFAULT_TARGETS["compressor"],
                                          np.float32)}
    for k in kinds:
        events[k + "_off"] = np.zeros(V, np.int32)
        events[k + "_vel"] = np.ones(V, np.float32)
    static = dict(kinds=kinds, sample_rate=SR, block_size=64,
                  smooth_coeff=smoothing_coeff(SR), limiter_threshold=1.0,
                  family_static=(("kick", (("max_harmonics", 4),)),
                                 ("snare", (("max_harmonics", 4),))))
    return eng, state, events, static


def _source_scatter():
    eng, state, events, static = _kit()
    events["source_matrix"] = np.ones((8, 4), np.float32)
    return jax.make_jaxpr(functools.partial(
        eng._render_all, collect_sources=True, **static))(state, events)


def _sidechain_tap():
    from libgooey_tpu.parallel import mesh as pmesh

    eng, state, events, static = _kit()
    mesh = pmesh.make_mesh(2)
    return jax.make_jaxpr(functools.partial(
        pmesh.render_all_sharded, mesh=mesh, fx_order=("compressor",),
        sidechain_voice=1, **static))(state, events)


def _track_routing():
    from libgooey_tpu.core.smoother import SmootherBank, smoothing_coeff
    from libgooey_tpu.mixer import graph as graph_mod

    g = graph_mod.MixerGraph.with_default_layout(SR, 120.0)
    T = len(g.tracks)
    frames = jnp.zeros((graph_mod.SOURCE_CAPACITY, 2, 64), jnp.float32)
    targets = jnp.asarray(g._strip_targets())
    return jax.make_jaxpr(functools.partial(
        graph_mod.graph_block, coeff=smoothing_coeff(SR), block_size=64,
        sample_rate=SR, rack_keys=tuple(() for _ in range(T))))(
        SmootherBank.init(np.asarray(targets)), targets, frames,
        jnp.asarray(g.routing_matrix()), tuple(() for _ in range(T)),
        tuple(() for _ in range(T)))


def _wsola_stream():
    from libgooey_tpu.ops import wsola_stream as dws

    cfg = dws.make_config(SR, SR, 44100, 0.0, 44100.0, True, 1.0, 1.5)
    P3 = dws.pad_buffer(jnp.zeros((3, 44100), jnp.float32), cfg)
    w1 = jnp.ones(cfg.hop, jnp.float32)
    state = dws.state_tuple((jnp.float32(0.0), jnp.float32(0.0), False,
                             jnp.zeros(cfg.hop, jnp.float32),
                             jnp.zeros((2, cfg.hop), jnp.float32)))
    return jax.make_jaxpr(functools.partial(
        dws.stream_hops, n_hops=2, cfg=cfg))(P3, w1, w1, state)


def _wsola_search():
    from libgooey_tpu.ops import wsola_search as ws

    f = jnp.float32
    return jax.make_jaxpr(functools.partial(
        ws.search_hop, hop=882, wrap=False, nc=65, nf=32))(
        jnp.zeros(44100, jnp.float32), jnp.zeros(882, jnp.float32),
        f(0.0), f(400.0), f(6.0), f(1.0), f(40000.0), f(0.0), f(1.0),
        np.int32(65))


@pytest.mark.parametrize("site", [
    _source_scatter, _sidechain_tap, _track_routing, _wsola_stream,
    _wsola_search], ids=["source_scatter", "sidechain_tap", "track_routing",
                         "wsola_stream", "wsola_search"])
def test_contractions_carry_highest_precision(site):
    dots = [e for e in _primitives(site().jaxpr)
            if e.primitive.name == "dot_general"]
    assert dots
    for e in dots:
        assert e.params["precision"] == (jax.lax.Precision.HIGHEST,) * 2, e
