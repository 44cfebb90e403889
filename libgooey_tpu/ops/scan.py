"""Blocked linear-recurrence solvers: the reference's per-sample loops, rotated.

Every recursive one-pole / two-pole structure in the reference (parameter
smoothers, one-pole LPs, DC blockers, Chamberlin/TPT SVFs, biquads, pink-noise
poles, envelope followers with fixed coefficients) is a *linear* recurrence

    y[n] = a[n] * y[n-1] + b[n]          (first order)
    s[n] = A[n] @ s[n-1] + b[n]          (second order, 2-vector state)

which is associative under composition, so a first-order block of B
samples is solved in O(log B) parallel steps with
`jax.lax.associative_scan` over the trailing (sample) axis — fully
parallel across the leading voice axes.  Second-order banks run sample by
sample instead (see :func:`linrec2`).

State is carried *between* blocks by the caller: pass the previous block's
final value as ``y0`` / ``s0`` and keep the returned last sample.

Nonlinear recurrences (tanh feedback, attack/release-switching envelope
followers) are NOT expressible this way; see :func:`nonlinear_scan` for the
sample-sequential loop used by those.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from libgooey_tpu.ops import recurrence


def linrec1(a, b, y0, axis: int = -1):
    """Solve ``y[n] = a[n] * y[n-1] + b[n]`` along ``axis`` with ``y[-1]=y0``.

    ``a`` and ``b`` broadcast against each other; ``y0`` has the shape of a
    slice (the array without ``axis``).  Returns y with the shape of
    ``broadcast(a, b)``.
    """
    a, b = jnp.broadcast_arrays(jnp.asarray(a), jnp.asarray(b))

    def combine(left, right):
        a_l, b_l = left
        a_r, b_r = right
        return a_r * a_l, a_r * b_l + b_r

    a_c, b_c = jax.lax.associative_scan(combine, (a, b), axis=axis)
    return a_c * jnp.expand_dims(y0, axis) + b_c


def onepole(coeff, x, y0, axis: int = -1):
    """One-pole lowpass toward ``x``: ``y[n] = y[n-1] + coeff*(x[n]-y[n-1])``.

    This is the reference's universal smoothing/filtering primitive
    (src/utils/smoother.rs:120-137, one-pole LPs everywhere).
    ``coeff`` may be scalar or per-sample (time-varying cutoff).
    """
    coeff = jnp.asarray(coeff)
    return linrec1(1.0 - coeff, coeff * x, y0, axis=axis)


def onepole_const(coeff, x_const, y0, n: int, axis: int = -1):
    """Closed form of :func:`onepole` when the input is constant over a block.

    ``y[k] = x + (y0 - x) * (1-coeff)^(k+1)`` for k = 0..n-1.  O(1) memory
    traffic per sample instead of a scan — used for un-modulated parameter
    smoothing, which is the overwhelmingly common case.

    ``x_const`` and ``y0`` are slice-shaped; result gains a trailing ``n``
    axis (then moved to ``axis``).
    """
    q = 1.0 - jnp.asarray(coeff, jnp.float32)
    powers = jnp.power(q, jnp.arange(1, n + 1, dtype=jnp.float32))
    y = jnp.expand_dims(x_const, -1) + jnp.expand_dims(y0 - x_const, -1) * powers
    if axis != -1:
        y = jnp.moveaxis(y, -1, axis)
    return y


def linrec2_step(carry, coeffs):
    """One sample of ``s = A s_prev + b``: the op order the oracles pin."""
    s1p, s2p = carry
    c11, c12, c21, c22, d1, d2 = coeffs
    s1 = (c11 * s1p + c12 * s2p) + d1
    s2 = (c21 * s1p + c22 * s2p) + d2
    return (s1, s2), (s1, s2)


def linrec2(a11, a12, a21, a22, b1, b2, s0, axis: int = -1, *,
            impl: str | None = None):
    """Solve a 2-state linear recurrence ``s[n] = A[n] s[n-1] + b[n]``.

    All coefficient arrays broadcast together and include the sample axis
    (possibly length-1 for time-invariant filters).  ``s0`` is a pair
    ``(s1_0, s2_0)`` of slice-shaped arrays.  Returns ``(s1, s2)`` full
    trajectories.

    This is how Chamberlin/TPT SVFs and biquads run: per-sample
    coefficient trajectories (from smoothed parameters) are computed
    vectorized, then the state recursion runs sample by sample
    (:mod:`ops.recurrence`).  The associative scan (``impl="assoc"``)
    reassociates the 2x2 products, and for high-Q resonators (membrane
    bands, pitch-tracking bandpasses, Chamberlin at low damping) the
    resonant ring-up amplifies that noise: measured 2.6e-4..2.7e-3 against
    the per-sample oracles on tom2's ring/void/brush presets, against
    <3e-5 sequential.  ``impl`` is ``"assoc"`` or a
    :func:`recurrence.sequential_scan` choice.
    """
    arrs = jnp.broadcast_arrays(
        *(jnp.asarray(v) for v in (a11, a12, a21, a22, b1, b2))
    )
    a11, a12, a21, a22, b1, b2 = arrs

    if impl != "assoc":
        lead = a11.shape[:-1]
        s10 = jnp.broadcast_to(jnp.asarray(s0[0], a11.dtype), lead)
        s20 = jnp.broadcast_to(jnp.asarray(s0[1], a11.dtype), lead)
        _, (s1, s2) = nonlinear_scan(
            linrec2_step, (s10, s20), tuple(arrs), axis=axis, impl=impl)
        return s1, s2

    def combine(l, r):
        la11, la12, la21, la22, lb1, lb2 = l
        ra11, ra12, ra21, ra22, rb1, rb2 = r
        # A = A_r @ A_l
        c11 = ra11 * la11 + ra12 * la21
        c12 = ra11 * la12 + ra12 * la22
        c21 = ra21 * la11 + ra22 * la21
        c22 = ra21 * la12 + ra22 * la22
        # b = A_r @ b_l + b_r
        c1 = ra11 * lb1 + ra12 * lb2 + rb1
        c2 = ra21 * lb1 + ra22 * lb2 + rb2
        return c11, c12, c21, c22, c1, c2

    c11, c12, c21, c22, c1, c2 = jax.lax.associative_scan(
        combine, (a11, a12, a21, a22, b1, b2), axis=axis
    )
    s1_0 = jnp.expand_dims(s0[0], axis)
    s2_0 = jnp.expand_dims(s0[1], axis)
    s1 = c11 * s1_0 + c12 * s2_0 + c1
    s2 = c21 * s1_0 + c22 * s2_0 + c2
    return s1, s2


def cumsum_reset(x, reset, reset_base, y0, axis: int = -1):
    """Cumulative sum along ``axis`` that restarts at reset points.

    ``y[n] = x[n] + (reset[n] ? reset_base[n] : y[n-1])``, ``y[-1] = y0``.

    Used for oscillator-phase accumulation with phase reset at trigger
    offsets, and for elapsed-time counters.  Implemented as a first-order
    recurrence with a ∈ {0, 1} (exact in float).
    """
    reset_f = jnp.asarray(reset, x.dtype)
    a = 1.0 - reset_f
    b = x + reset_f * reset_base
    return linrec1(a, b, y0, axis=axis)


def phase_cumsum_reset(inc, reset, carry, axis: int = -1):
    """Mod-1 oscillator phase with trigger resets, accurate to ~1e-7 cycles.

    Same recurrence as ``cumsum_reset`` with a zero reset base —
    ``y[n] = inc[n] + (reset[n] ? 0 : y[n-1])`` — but returned already
    reduced mod 1 and computed so every intermediate stays O(1) cycle.  A
    raw tree cumsum grows to ``inc*B`` cycles per block and rounds at
    ``eps(inc*B)`` per combine level (7.6e-6 cycles per rounding for a
    10 kHz oscillator over a 512 block) — phase-modulation chains amplify
    that ~30x into the output.  Here the block-start increment is split
    ``inc0 = hi + lo`` with ``hi`` on a 2^-11 grid, so ``hi*(n+1)`` and its
    mod-1 reduction are EXACT in f32 for n < 8192; ``lo*(n+1)`` (< 1 cycle)
    and the residual cumsum of ``inc - inc0`` (tiny for smoothed frequency
    trajectories) carry one rounding each.

    ``carry`` is the previous block's last mod-1 phase.  Returns the [..,
    B] mod-1 phase trajectory; carry forward ``out[..., -1]``.
    """
    inc = jnp.asarray(inc, jnp.float32)
    reset_f = jnp.asarray(reset, jnp.float32)
    B = inc.shape[axis]
    assert axis in (-1, inc.ndim - 1), "sample axis must be last"
    n1 = jnp.arange(1, B + 1, dtype=jnp.float32)
    inc0 = jax.lax.slice_in_dim(inc, 0, 1, axis=-1)
    hi = jnp.floor(inc0 * 2048.0) * jnp.float32(1.0 / 2048.0)
    lo = inc0 - hi                        # exact (Sterbenz)
    ramp_hi = hi * n1                     # exact: <= 2^24 grid steps
    ramp_hi = ramp_hi - jnp.floor(ramp_hi)  # exact mod-1 (2^-11 grid)
    ramp = ramp_hi + lo * n1
    resid = jnp.cumsum(inc - inc0, axis=-1)
    p = jnp.mod(ramp + resid, 1.0)        # mod-1 prefix sums, P~[n]
    # base latch: the mod-1 prefix just BEFORE the governing reset
    # (base[n] = reset[n] ? P~[n-1] : base[n-1]; init -carry so the no-reset
    # phase is carry + P~[n])
    p_prev = jnp.concatenate(
        [jnp.zeros_like(inc0), p[..., :-1]], axis=-1
    )
    carry = jnp.asarray(carry, jnp.float32)
    base = linrec1(1.0 - reset_f, reset_f * p_prev, -carry, axis=axis)
    return jnp.mod(p - base, 1.0)


def maxlin(a, b, c, y0, axis: int = -1):
    """Solve ``y[n] = max(a[n], b[n]*y[n-1] + c[n])`` by associative scan.

    Max-affine maps with one linear piece are closed under composition:
    ``f2∘f1 = (max(a2, b2*a1 + c2), b2*b1, b2*c1 + c2)`` — so "instant up,
    smoothed down" trackers (the HiHat2 envelope smoother,
    src/instruments/hihat2.rs:290-320: ``y = target if target >= y else
    y + k*(target - y)`` ≡ ``max(target, (1-k)y + k*target)`` for b ≥ 0)
    run in O(log B) like any linear recurrence.
    """
    a, b, c = jnp.broadcast_arrays(jnp.asarray(a), jnp.asarray(b), jnp.asarray(c))

    def combine(l, r):
        a_l, b_l, c_l = l
        a_r, b_r, c_r = r
        return jnp.maximum(a_r, b_r * a_l + c_r), b_r * b_l, b_r * c_l + c_r

    a_c, b_c, c_c = jax.lax.associative_scan(combine, (a, b, c), axis=axis)
    return jnp.maximum(a_c, b_c * jnp.expand_dims(y0, axis) + c_c)


def asym_smooth(target, down_coeff, y0, reset=None, axis: int = -1):
    """Asymmetric smoother: instant up, one-pole down (hihat2.rs:290-320).

    ``reset`` forces the state to 0 at masked samples *before* processing
    (the trigger resets the smoother to 0, hihat2.rs:443)."""
    k = jnp.asarray(down_coeff, jnp.float32)
    a = target
    b = jnp.broadcast_to(1.0 - k, jnp.shape(target)).astype(jnp.float32)
    c = k * target
    if reset is not None:
        # at a reset sample: y = max(t, (1-k)*0 + k*t) = t... the reference
        # resets then processes, giving y = max(t, k*t) = t for t >= 0.
        b = jnp.where(reset, 0.0, b)
    return maxlin(a, b, c, y0, axis=axis)


def nonlinear_scan(step_fn, state, xs, axis: int = -1, *,
                   impl: str | None = None):
    """Sequential per-sample loop for recurrences a tree scan cannot take.

    ``step_fn(state, x_slice) -> (state, y_slice)`` where slices are the
    arrays without the sample axis (i.e. ``[V]``-shaped).  ``xs`` is a pytree
    of arrays with the sample axis at ``axis``.  Runs B sequential steps,
    each parallel over the lanes, through
    :func:`recurrence.sequential_scan` (``impl`` as there).  State leaves
    have the lane shape of ``xs``.

    Reference counterparts: the feedback waveshaper's tanh loop
    (src/effects/feedback_waveshaper.rs:118-170), compressor envelope
    follower with attack/release switching (src/effects/compressor.rs:96-99).
    """
    xs_t = jax.tree_util.tree_map(lambda v: jnp.moveaxis(v, axis, 0), xs)
    state, ys_t = recurrence.sequential_scan(step_fn, state, xs_t, impl=impl)
    ys = jax.tree_util.tree_map(lambda v: jnp.moveaxis(v, 0, axis), ys_t)
    return state, ys
