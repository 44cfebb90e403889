"""Multi-device scaling: shard the voice axis over a device mesh.

The reference is a single-audio-thread engine; its only cross-voice
communication is the final additive mix (SURVEY.md §2.10).  The scaling
story is therefore pure data parallelism over voices:

* every per-voice array in the engine state is sharded on a 1-D ``voices``
  mesh axis;
* the per-block render is embarrassingly parallel until the mix;
* the stereo mix-down ``[2, V] @ [V, B]`` contracts over the sharded axis —
  XLA turns it into a local partial mix + ``psum`` (one [2, B]
  vector per block: negligible traffic);
* bus effects (global FX chain) run replicated after the reduction.

Control (sequencer events, parameter targets) is broadcast from the host;
event arrays are ``[V]``-sharded like the state.

Two sharded execution paths:

* **GSPMD** (plain jit over sharded arrays): flexible — any feature incl.
  poly.
* **shard_map** (:func:`render_all_sharded`): runs ``engine._render_all``
  per shard on LOCAL voice slices; the mix is an explicit ``psum`` of one
  ``[2, B]`` frame per block.  This path carries the FULL product scope:
  LFO routes and the compressor sidechain resolve their global voice ids
  per-shard (``axis_index`` row masks; the sidechain tap is one extra
  [B] psum), the user-ordered bus chain + limiter run replicated after
  the mix psum, and ``collect_sources`` shards the source-matrix scatter.
  Only poly stays GSPMD-only (slot-level params vs lane-level voices).

``tests/test_parallel.py`` and ``__graft_entry__.dryrun_multichip`` pin the
sharded==single-device equality for the full kit (kick/snare/hihat2/tom2/
bass) on both paths, the replicated bus chain after the psum, and sharded
granulator / sampler arena reads.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

VOICE_AXIS = "voices"


def make_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """A 1-D mesh over the voice axis."""
    if devices is None:
        devices = jax.devices()[: n_devices or len(jax.devices())]
    return Mesh(np.array(devices), (VOICE_AXIS,))


def voice_sharding(mesh: Mesh) -> NamedSharding:
    """Sharding for arrays whose leading axis is the voice axis."""
    return NamedSharding(mesh, P(VOICE_AXIS))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def _voice_spec_tree(tree, mesh: Mesh, *, overrides=None):
    """PartitionSpec pytree matching ``tree``: leading-voice-axis arrays get
    ``P(VOICE_AXIS)``, everything else ``P()``.  ``overrides`` maps top-level
    dict keys to explicit specs (e.g. ``source_matrix`` sharded on axis 1)."""
    overrides = overrides or {}

    def spec_of(x):
        x = jax.numpy.asarray(x)
        if x.ndim >= 1 and x.shape[0] % mesh.devices.size == 0 and x.shape[0] > 1:
            return P(VOICE_AXIS)
        return P()

    out = {}
    for key, sub in tree.items():
        if key in overrides:
            out[key] = overrides[key]
        else:
            out[key] = jax.tree_util.tree_map(spec_of, sub)
    return out


def _event_specs(events, kinds, mesh):
    """Key-aware PartitionSpecs for an engine event dict: per-family
    trigger/velocity/freq arrays shard on their leading (voice) axis,
    ``source_matrix`` on its column axis, everything else (block_start,
    lfo_*, fx_*) is replicated.  Key-aware, NOT shape-heuristic: an
    ``lfo_phase`` of shape [8] on an 8-device mesh must stay replicated."""
    voice_keys = set()
    for k in kinds:
        voice_keys.update((k + "_off", k + "_vel"))
    voice_keys.update(("poly_freq", "poly_rel", "bass_freq"))
    specs = {}
    for key, val in events.items():
        arr = jax.numpy.asarray(val)
        if key == "source_matrix":
            specs[key] = P(None, VOICE_AXIS)
        elif key in voice_keys:
            specs[key] = P(*((VOICE_AXIS,) + (None,) * (arr.ndim - 1)))
        else:
            specs[key] = jax.tree_util.tree_map(lambda x: P(), val)
    return specs


def _state_specs(state, kinds, events, mesh):
    """Key-aware PartitionSpecs for the engine state: instrument-bank
    leaves shard iff their leading dim is that family's voice count
    (packed chain states like ``[2, K]`` oversampler leaves on a 2-device
    mesh must NOT shard); pan/gain shard; master/fx_* replicate."""
    specs = {}
    for key, sub in state.items():
        if key in kinds:
            Vk = int(jax.numpy.asarray(events[key + "_off"]).shape[0])

            def spec_of(x, Vk=Vk):
                x = jax.numpy.asarray(x)
                if x.ndim >= 1 and x.shape[0] == Vk:
                    return P(*((VOICE_AXIS,) + (None,) * (x.ndim - 1)))
                return P()

            specs[key] = jax.tree_util.tree_map(spec_of, sub)
        elif key in ("pan", "gain"):
            specs[key] = jax.tree_util.tree_map(
                lambda x: P(VOICE_AXIS), sub)
        else:
            specs[key] = jax.tree_util.tree_map(lambda x: P(), sub)
    return specs


def render_all_sharded(state, events, *, mesh: Mesh, **static):
    """One engine block over the mesh as one ``shard_map`` program.

    Wraps ``engine._render_all`` in ``jax.shard_map`` over the voice axis:
    each shard renders its local voice slice, then the
    ``[2, B]`` mix and ``[B]`` mono sum all-reduce with ``psum`` and the
    replicated bus chain + limiter run identically on every shard.  This is
    the ONE path that carries the full product: the banks, LFO routes
    (global slot ids resolved per-shard via ``axis_index``), the
    sidechained compressor (owning shard masks its tap, one [B] psum), the
    user-ordered bus chain, and — with ``collect_sources=True`` — the
    mixer-graph source scatter (source_matrix column-sharded, [S, 2, B]
    psum).

    ``state``/``events`` follow ``shard_voice_tree``'s placement convention.
    Returns ``(new_state, stereo[2, B], mono[B])`` — or, with
    ``collect_sources``, ``(new_state, sources[S, 2, B], all_voices[V, B],
    voice_peaks[V])`` with the voice-axis outputs restored to family-concat
    order.  Static kwargs are ``engine._render_all``'s.  ``poly`` is not
    supported under shard_map (its
    slot-level param bank does not share the lane-level voice axis) — use
    the GSPMD path for poly-bearing configs.
    """
    from libgooey_tpu.engine import engine as eng

    static = dict(static)
    static["psum_axis"] = VOICE_AXIS
    kinds = static["kinds"]
    if "poly" in kinds:
        raise ValueError("poly is not supported under shard_map; "
                         "use the GSPMD path")
    collect = bool(static.get("collect_sources"))

    # The flat mixer banks (pan/gain) index voices in family-concat order
    # [f0 voices..., f1 voices...].  Inside shard_map each shard
    # concatenates its LOCAL family slices, so the global order of the
    # per-shard voice axis becomes shard-major interleaved:
    #   shard s rows = [f0[s*v0/D:(s+1)*v0/D], f1[...], ...]
    # Permute pan/gain (and source_matrix columns) into that order before
    # sharding (and back after) so each shard's local slice carries exactly
    # its own voices' mix params.
    D = mesh.devices.size
    sizes = [events[k + "_off"].shape[0] for k in kinds]
    assert all(v % D == 0 for v in sizes), (
        f"family voice counts {sizes} must divide the mesh size {D}")
    offsets = np.cumsum([0] + sizes[:-1])
    perm = np.concatenate([
        np.arange(o + s * (v // D), o + (s + 1) * (v // D))
        for s in range(D)
        for o, v in zip(offsets, sizes)
    ])
    inv = np.argsort(perm)

    def permute_mix(st, idx):
        st = dict(st)
        for key in ("pan", "gain"):
            bank = st[key]
            st[key] = type(bank)(current=bank.current[idx],
                                 target=bank.target[idx])
        return st

    state = permute_mix(state, perm)
    if collect:
        events = dict(events)
        events["source_matrix"] = jax.numpy.asarray(
            events["source_matrix"])[:, perm]
    state_specs = _state_specs(state, kinds, events, mesh)
    event_specs = _event_specs(events, kinds, mesh)

    def local_step(st, ev):
        return eng._render_all(st, ev, **static)

    if collect:
        out_specs = (state_specs, P(), P(VOICE_AXIS), P(VOICE_AXIS))
        new_state, sources, all_voices, peaks = jax.shard_map(
            local_step, mesh=mesh,
            in_specs=(state_specs, event_specs), out_specs=out_specs,
            check_vma=False,
        )(state, events)
        return (permute_mix(new_state, inv), sources,
                all_voices[inv], peaks[inv])
    new_state, out, mono = jax.shard_map(
        local_step,
        mesh=mesh,
        in_specs=(state_specs, event_specs),
        out_specs=(state_specs, P(), P()),
        check_vma=False,
    )(state, events)
    return permute_mix(new_state, inv), out, mono


def shard_voice_tree(tree, mesh: Mesh):
    """Place a state pytree on the mesh: arrays with a leading voice axis are
    sharded on it, scalars/others replicated.

    Heuristic: every array in an instrument bank state has the voice axis
    leading (by construction of ``init_state``); smoother banks are
    ``[V, P]``; scalar transports are 0-d.
    """
    vs = voice_sharding(mesh)
    rep = replicated(mesh)

    def place(x):
        x = jax.numpy.asarray(x)
        if x.ndim >= 1 and x.shape[0] % mesh.devices.size == 0 and x.shape[0] > 1:
            return jax.device_put(x, vs)
        return jax.device_put(x, rep)

    return jax.tree_util.tree_map(place, tree)
