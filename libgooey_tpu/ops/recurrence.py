"""Sample-sequential recurrences over lane banks: one GPU kernel, one reference.

Every recurrence the scans in ``ops/scan.py`` cannot reassociate runs
through :func:`sequential_scan`: the second-order banks behind
``linrec2`` (biquads, TPT and Chamberlin SVFs, membrane bands, the delay
filter) and the nonlinear loops behind ``nonlinear_scan`` (the ladder
lowpass, the compressor detector, the envelope followers and the general
feedback waveshaper).  Each is one per-sample ``step_fn`` applied to many
independent lanes (voices, bands, or the two stereo channels).

Two implementations of the same op order:

* ``"scan"``: ``lax.scan`` over the sample axis.  The reference, and the
  path on the CPU, where the per-sample oracles pin it at 1e-4.
* ``"kernel"``: one Pallas kernel through Triton.  The grid runs over
  lane tiles; each program walks the block with ``fori_loop`` and keeps
  the state in registers.  Operands are laid out ``[B, lanes]`` so each
  step loads and stores one coalesced row per operand, and the rows of a
  chunk of samples are loaded before any of them is computed.  On the GPU
  it replaces a device while loop that launches kernels every sample.

The choice is :func:`default_impl`: the kernel on ``"gpu"``, the scan
everywhere else.  Interpret mode is never chosen here; only tests pass
``interpret=True``.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

#: lanes per program (at most one warp); Triton blocks are powers of two
MAX_TILE = 32
MIN_TILE = 16
#: samples per loop iteration; a chunk's loads issue before its math
UNROLL = 8


def default_impl(platform: str | None = None) -> str:
    """``"kernel"`` on the GPU, ``"scan"`` on any other platform."""
    if platform is None:
        platform = jax.default_backend()
    return "kernel" if platform == "gpu" else "scan"


def lane_tile(lanes: int) -> int:
    """Power-of-two lane tile for a bank of ``lanes`` lanes."""
    t = MIN_TILE
    while t < min(lanes, MAX_TILE):
        t *= 2
    return t


def _to_kernel_dtype(dtype):
    # Triton loads and stores no i1; booleans travel as int32
    return jnp.int32 if dtype == jnp.bool_ else dtype


def _kernel(*refs, step_fn, n_steps, tile, c_def, x_def, c_dtypes, x_dtypes,
            y_dtypes):
    nc, nx, ny = len(c_dtypes), len(x_dtypes), len(y_dtypes)
    c_in = refs[:nc]
    x_in = refs[nc:nc + nx]
    y_out = refs[nc + nx:nc + nx + ny]
    c_out = refs[nc + nx + ny:]

    def load(v, dtype):
        return v != 0 if dtype == jnp.bool_ else v

    def step(carry, xs):
        carry = jax.tree_util.tree_unflatten(
            c_def, [load(v, dt) for v, dt in zip(carry, c_dtypes)])
        carry, ys = step_fn(carry, jax.tree_util.tree_unflatten(x_def, xs))
        carry = tuple(
            jnp.broadcast_to(v, (tile,)).astype(_to_kernel_dtype(dt))
            for v, dt in zip(jax.tree_util.tree_leaves(carry), c_dtypes))
        return carry, jax.tree_util.tree_leaves(ys)

    # Unrolled by hand (the Triton lowering takes no ``unroll=``), and all
    # of a chunk's loads come before its stores: the compiler cannot prove
    # that a store does not alias a later load, so interleaving them would
    # expose the full load latency on every sample.
    unroll = UNROLL if n_steps % UNROLL == 0 else 1

    def body(j, carry):
        rows = [j * unroll + k for k in range(unroll)]
        xs = [[load(r[i, :], dt) for r, dt in zip(x_in, x_dtypes)]
              for i in rows]
        out = []
        for x in xs:
            carry, ys = step(carry, x)
            out.append(ys)
        for i, ys in zip(rows, out):
            for r, v in zip(y_out, ys):
                r[i, :] = jnp.broadcast_to(v, (tile,)).astype(r.dtype)
        return carry

    carry = jax.lax.fori_loop(
        0, n_steps // unroll, body, tuple(r[...] for r in c_in))
    for r, v in zip(c_out, carry):
        r[...] = v


def _run_kernel(step_fn, carry, xs, *, interpret):
    c_leaves, c_def = jax.tree_util.tree_flatten(carry)
    x_leaves, x_def = jax.tree_util.tree_flatten(xs)
    n_steps = x_leaves[0].shape[0]
    lead = x_leaves[0].shape[1:]
    for v in c_leaves:
        if v.shape != lead:
            raise ValueError(
                f"state leaf {v.shape} does not match the lane shape {lead}")
    lanes = int(np.prod(lead, dtype=np.int64))
    tile = lane_tile(lanes)
    padded = -(-lanes // tile) * tile

    def flat_lanes(v, axis0):
        v = v.reshape(v.shape[:axis0] + (lanes,))
        v = v.astype(_to_kernel_dtype(v.dtype))
        pad = [(0, 0)] * axis0 + [(0, padded - lanes)]
        return jnp.pad(v, pad)

    c_dtypes = tuple(v.dtype for v in c_leaves)
    x_dtypes = tuple(v.dtype for v in x_leaves)
    slice_of = lambda v: jax.ShapeDtypeStruct(v.shape[1:], v.dtype)
    _, y_shape = jax.eval_shape(
        step_fn, carry, jax.tree_util.tree_map(slice_of, xs))
    y_structs, y_def = jax.tree_util.tree_flatten(y_shape)
    y_dtypes = tuple(s.dtype for s in y_structs)

    row = pl.BlockSpec((n_steps, tile), lambda j: (0, j))
    lane = pl.BlockSpec((tile,), lambda j: (j,))
    out_shape = (
        [jax.ShapeDtypeStruct((n_steps, padded), _to_kernel_dtype(dt))
         for dt in y_dtypes]
        + [jax.ShapeDtypeStruct((padded,), _to_kernel_dtype(dt))
           for dt in c_dtypes])
    outs = pl.pallas_call(
        functools.partial(
            _kernel, step_fn=step_fn, n_steps=n_steps, tile=tile,
            c_def=c_def, x_def=x_def, c_dtypes=c_dtypes,
            x_dtypes=x_dtypes, y_dtypes=y_dtypes),
        out_shape=out_shape,
        grid=(padded // tile,),
        in_specs=[lane] * len(c_leaves) + [row] * len(x_leaves),
        out_specs=[row] * len(y_dtypes) + [lane] * len(c_dtypes),
        backend="triton",
        compiler_params=plt.CompilerParams(num_warps=1),
        interpret=interpret,
        name="sequential_scan",
    )(*[flat_lanes(v, 0) for v in c_leaves],
      *[flat_lanes(v, 1) for v in x_leaves])

    def unflat(v, dtype, axis0):
        v = v[..., :lanes].reshape(v.shape[:axis0] + lead)
        return v != 0 if dtype == jnp.bool_ else v.astype(dtype)

    ys = [unflat(v, dt, 1) for v, dt in zip(outs[:len(y_dtypes)], y_dtypes)]
    cs = [unflat(v, dt, 0) for v, dt in zip(outs[len(y_dtypes):], c_dtypes)]
    return (jax.tree_util.tree_unflatten(c_def, cs),
            jax.tree_util.tree_unflatten(y_def, ys))


def sequential_scan(step_fn, carry, xs, *, impl: str | None = None,
                    interpret: bool = False):
    """``lax.scan(step_fn, carry, xs)`` over a sample-major lane bank.

    ``xs`` is a pytree of ``[B, *lanes]`` arrays; ``carry`` a pytree of
    ``lanes``-shaped arrays.  ``step_fn(carry, x) -> (carry, y)`` sees
    lane slices and must not close over arrays (Python scalars are fine).
    Returns ``(carry, ys)`` with ``ys`` leaves shaped ``[B, *lanes]``.

    ``impl``: ``"scan"``, ``"kernel"``, or ``None`` for
    :func:`default_impl`.  ``interpret`` runs the kernel through the Pallas
    interpreter (CPU tests).
    """
    impl = default_impl() if impl is None else impl
    if impl == "scan":
        return jax.lax.scan(step_fn, carry, xs)
    if impl != "kernel":
        raise ValueError(f"unknown impl {impl!r}")
    return _run_kernel(step_fn, carry, xs, interpret=interpret)
