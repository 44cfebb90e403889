"""2x/4x oversampling via polyphase IIR half-band allpass pairs.

Behavioral reference: src/utils/oversampler.rs (the reference wraps the
`halfband` crate's polyphase IIR half-band up/down-samplers, 94 dB
attenuation, around a memoryless nonlinearity; modes Off/X2/X4, default X4).

Design: the classic elliptic half-band decomposition H(z) = (A0(z^2) +
z^-1 A1(z^2))/2 where A0/A1 are chains of first-order (per phase) allpass
sections ``y[k] = a*x[k] + x[k-1] - a*y[k-1]``.  Coefficients come from the
standard analytic elliptic design (Valenzuela & Constantinides; the same
algorithm behind the hiir library), computed here and verified by the test
suite to exceed 90 dB stop-band attenuation.

Block mapping: each allpass section is a first-order linear recurrence at the
*low* rate — associative scans — so up/down-sampling a whole block is a
handful of linrec1 passes; the nonlinearity runs vectorized at the high
rate.  State (one value per section per path) is threaded explicitly.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from libgooey_tpu.ops import scan as gscan


def design_halfband(n_coefs: int, transition: float):
    """Analytic elliptic half-band allpass coefficients.

    ``transition``: normalized transition bandwidth (fraction of fs, e.g.
    0.04 → passband up to 0.25-0.02 of fs after decimation).  Returns
    ``n_coefs`` allpass coefficients, split even/odd across the two phases.
    """
    k = math.tan((1.0 - transition * 2.0) * math.pi / 4.0)
    k *= k
    ksqrt4 = (1.0 - k * k) ** 0.25
    e = 0.5 * (1.0 - ksqrt4) / (1.0 + ksqrt4)
    q = e * (1.0 + e**4 * (2.0 + e**4 * (15.0 + 150.0 * e**4)))
    order = n_coefs * 2 + 1

    def acc_num(c):
        acc, i, sign = 0.0, 0, 1.0
        while True:
            term = sign * (q ** (i * (i + 1))) * math.sin((2 * i + 1) * c)
            acc += term
            if abs(term) < 1e-100:
                break
            i += 1
            sign = -sign
        return acc

    def acc_den(c):
        acc, i, sign = 0.0, 1, -1.0
        while True:
            term = sign * (q ** (i * i)) * math.cos(2 * i * c)
            acc += term
            if abs(term) < 1e-100:
                break
            i += 1
            sign = -sign
        return acc

    coefs = []
    for idx in range(1, n_coefs + 1):
        c = math.pi * idx / order
        ww = (q**0.25) * acc_num(c) / (acc_den(c) + 0.5)
        wwsq = ww * ww
        x = math.sqrt((1.0 - wwsq * k) * (1.0 - wwsq / k)) / (1.0 + wwsq)
        coefs.append((1.0 - x) / (1.0 + x))
    return coefs


#: Stage designs: (n_coefs, transition).  The first (audio-band) stage does
#: the steep work; the second stage of a 4x chain has a full octave of slack.
STAGE1 = design_halfband(8, 0.04)    # ~>95 dB, passband to ~0.21 fs
STAGE2 = design_halfband(4, 0.20)    # wide-transition cleanup stage


def _split(coefs):
    """hiir phase split: even-indexed coefs drive the z^-1-delayed branch."""
    return coefs[0::2], coefs[1::2]


class HalfbandState(NamedTuple):
    """Per-section states for one half-band (both phases + input delay).

    ``*y2``/``*x2`` hold each section's second-to-last output/input sample.
    The scans here do not read them; they are what a deinterleaved (even/
    odd) stage-2 evaluation would need to resume: index [-2] of the
    interleaved stream.
    """

    ap0: jnp.ndarray   # [..., n0]
    ap0x: jnp.ndarray  # [..., n0] previous-input memories
    ap1: jnp.ndarray
    ap1x: jnp.ndarray
    x1: jnp.ndarray    # [...] previous input sample (odd-phase delay)
    ap0y2: jnp.ndarray  # [..., n0] second-to-last outputs
    ap0x2: jnp.ndarray  # [..., n0] second-to-last inputs
    ap1y2: jnp.ndarray
    ap1x2: jnp.ndarray

    @staticmethod
    def init(coefs, batch=()) -> "HalfbandState":
        c0, c1 = _split(coefs)
        z = lambda n: jnp.zeros(tuple(batch) + (n,), jnp.float32)
        return HalfbandState(
            ap0=z(len(c0)), ap0x=z(len(c0)), ap1=z(len(c1)), ap1x=z(len(c1)),
            x1=jnp.zeros(batch, jnp.float32),
            ap0y2=z(len(c0)), ap0x2=z(len(c0)),
            ap1y2=z(len(c1)), ap1x2=z(len(c1)),
        )


#: Chunk length for the Toeplitz-matmul allpass path (one matmul tile).
_NC = 128
#: Minimum flattened batch (voice-lane) count at which the matmul path
#: beats the associative scans.  Small batches (the stereo bus effects,
#: few-voice tests) keep the scan path and its exact round-1 numerics.
_MX_MIN_BATCH = 64


@functools.lru_cache(maxsize=None)
def _toeplitz_consts(pairs_key, nc):
    """Per-section matmul constants for the constant-coefficient recurrence
    ``y[n] = -a*y[n-1] + b[n]`` solved a chunk at a time:

        y_chunk = b_chunk @ U_a  +  y_carry * p_a

    with ``U_a[k, m] = (-a)^(m-k)`` (upper-triangular Toeplitz: row k
    scatters input sample k into outputs m >= k), ``p_a[m] = (-a)^(m+1)``
    (carry-in propagation) and ``r_a = (-a)^nc`` (chunk-to-chunk carry
    decay).  Built in f64, returned f32: [n, 2, nc, nc], [n, 2, nc], [n, 2].
    """
    pairs = np.asarray(pairs_key, np.float64).reshape(-1, 2)
    n = pairs.shape[0]
    idx = np.arange(nc)
    d = idx[None, :] - idx[:, None]  # output index minus input index
    U = np.zeros((n, 2, nc, nc), np.float64)
    p = np.zeros((n, 2, nc), np.float64)
    r = np.zeros((n, 2), np.float64)
    for i in range(n):
        for ph in range(2):
            pw = (-pairs[i, ph]) ** np.arange(nc + 1)  # int exponents
            U[i, ph] = np.where(d >= 0, pw[np.clip(d, 0, nc)], 0.0)
            p[i, ph] = pw[1:]
            r[i, ph] = pw[nc]
    return (U.astype(np.float32), p.astype(np.float32), r.astype(np.float32))


def _allpass_chain_paired_mx(sig, coef_pairs, y0s, x0s):
    """Toeplitz-matmul formulation of :func:`_allpass_chain_paired` for wide
    voice banks.

    Each section's coefficient is a *compile-time constant*, so the whole
    first-order recurrence over a chunk of ``_NC`` samples is one matmul
    against a precomputed triangular Toeplitz matrix — matmul work instead of
    a log-depth associative scan whose passes round-trip [V, B] arrays
    through device memory.  Chunk carries propagate through a static Python
    loop over the (few) chunks.  HIGHEST precision: a DEFAULT f32 matmul
    may round its operands (bf16 or TF32, depending on the device), far off
    the -80 dBFS bar.
    """
    N = sig.shape[-1]
    C = N // _NC
    key = tuple(np.asarray(coef_pairs, np.float64).ravel().tolist())
    U, p, r = _toeplitz_consts(key, _NC)
    mid = (1,) * (sig.ndim - 2)  # broadcast shape over the voice axes
    new_y, new_x, new_y2, new_x2 = [], [], [], []
    for i in range(coef_pairs.shape[0]):
        a = jnp.asarray(coef_pairs[i], jnp.float32).reshape((2,) + mid + (1,))
        x_prev = jnp.concatenate([x0s[..., i : i + 1], sig[..., :-1]], axis=-1)
        b = a * sig + x_prev
        yloc = jnp.einsum(
            "p...k,pkm->p...m",
            b.reshape(sig.shape[:-1] + (C, _NC)),
            jnp.asarray(U[i]),
            precision=jax.lax.Precision.HIGHEST,
        )
        # chunk-carry recurrence over the (static, small) chunk count
        ri = jnp.asarray(r[i], jnp.float32).reshape((2,) + mid)
        carry = y0s[..., i]
        carries = []
        for c in range(C):
            carries.append(carry)
            carry = yloc[..., c, -1] + ri * carry
        carry_in = jnp.stack(carries, axis=-1)  # [2, ..., C]
        pi = jnp.asarray(p[i]).reshape((2,) + mid + (1, _NC))
        y = (yloc + carry_in[..., None] * pi).reshape(sig.shape)
        new_x.append(sig[..., -1])
        new_y.append(carry)  # == y[..., -1], exactly
        new_x2.append(sig[..., -2])
        new_y2.append(y[..., -2])
        sig = y
    return (sig, jnp.stack(new_y, axis=-1), jnp.stack(new_x, axis=-1),
            jnp.stack(new_y2, axis=-1), jnp.stack(new_x2, axis=-1))


#: Wide-bank chain formulation: "lifted" composes the WHOLE chain into one
#: chunk-lifted state-space operator (one [nc, nc] matmul per chunk instead
#: of one per section — S-fold fewer matmul passes and HBM round-trips);
#: "toeplitz" keeps the per-section matmuls (round-4 numerics, kept for
#: A/B and fallback).
MX_CHAIN_IMPL = "lifted"


@functools.lru_cache(maxsize=None)
def _lifted_consts(pairs_key, nc):
    """Chunk-lifted operators for a WHOLE per-phase allpass chain.

    The chain of S first-order allpasses is one linear system with state
    ``z = [y_1, x_1, .., y_S, x_S]`` (section output/input memories):
    ``z' = A z + B u``, ``out = C z + D u``.  Lifting a chunk of ``nc``
    samples gives (all built in f64, returned f32, per phase):

    * ``U [nc, nc]``: input→output Toeplitz, ``U[k, m] = C A^(m-k-1) B``
      (``D`` on the diagonal) — ONE matmul applies the whole chain;
    * ``P [Z, nc]``: state→output, column m = ``(C A^m)^T``;
    * ``T [Z, Z]``: chunk state transition ``A^nc`` (transposed for the
      right-multiply einsum);
    * ``Bm [nc, Z]``: input→state, row k = ``A^(nc-1-k) B``;
    * ``T2/Bm2``: same to the SECOND-TO-LAST sample of the final chunk
      (the HalfbandState ``*y2/*x2`` captures).
    """
    pairs = np.asarray(pairs_key, np.float64).reshape(-1, 2)
    S = pairs.shape[0]
    Z = 2 * S
    outs = []
    for ph in range(2):
        a = pairs[:, ph]

        def step(z, u):
            z2 = z.copy()
            cur = u
            for j in range(S):
                y = a[j] * (cur - z[2 * j]) + z[2 * j + 1]
                z2[2 * j] = y
                z2[2 * j + 1] = cur
                cur = y
            return z2, cur

        A = np.zeros((Z, Z))
        Cv = np.zeros(Z)
        for k in range(Z):
            e = np.zeros(Z)
            e[k] = 1.0
            z2, o = step(e, 0.0)
            A[:, k] = z2
            Cv[k] = o
        Bv, D = step(np.zeros(Z), 1.0)

        Apow = [np.eye(Z)]
        for _m in range(nc):
            Apow.append(Apow[-1] @ A)
        U = np.zeros((nc, nc))
        for m in range(nc):
            U[m, m] = D
            for k in range(m):
                U[k, m] = Cv @ Apow[m - k - 1] @ Bv
        P = np.stack([Cv @ Apow[m] for m in range(nc)], axis=1)     # [Z, nc]
        T = Apow[nc].T                                              # [Z, Z]
        Bm = np.stack([Apow[nc - 1 - k] @ Bv for k in range(nc)])   # [nc, Z]
        T2 = Apow[nc - 1].T
        Bm2 = np.stack([(Apow[nc - 2 - k] @ Bv) if k < nc - 1
                        else np.zeros(Z) for k in range(nc)])
        outs.append((U, P, T, Bm, T2, Bm2))
    return tuple(
        np.stack([outs[0][i], outs[1][i]], axis=0).astype(np.float32)
        for i in range(6)
    )


def _allpass_chain_lifted_mx(sig, coef_pairs, y0s, x0s):
    """Whole-chain chunk-lifted formulation of the paired allpass chains.

    One [nc, nc] HIGHEST-precision matmul per chunk applies ALL S
    sections at once (vs one per section), plus tiny [Z]-wide state
    einsums — S-fold fewer matmul passes AND only one [.., N] intermediate
    per chain instead of per section.  Constants are exact f64 lifts of
    the recurrence (:func:`_lifted_consts`); f32 rounding differs from
    the per-section path by reassociation only (same tolerance class as
    the Toeplitz path vs the scans; pinned by test_oversample)."""
    N = sig.shape[-1]
    C = N // _NC
    S = coef_pairs.shape[0]
    key = tuple(np.asarray(coef_pairs, np.float64).ravel().tolist())
    U, P, T, Bm, T2, Bm2 = (jnp.asarray(c) for c in _lifted_consts(key, _NC))
    HI = jax.lax.Precision.HIGHEST
    # state z = [y_1, x_1, ..] per phase: [2, ..., Z]
    parts = []
    for j in range(S):
        parts += [y0s[..., j], x0s[..., j]]
    z = jnp.stack(parts, axis=-1)
    b = sig.reshape(sig.shape[:-1] + (C, _NC))
    y_in = jnp.einsum("p...ck,pkm->p...cm", b, U, precision=HI)
    zs = []
    for c in range(C):
        zs.append(z)
        z = (jnp.einsum("p...s,pst->p...t", z, T, precision=HI)
             + jnp.einsum("p...k,pks->p...s", b[..., c, :], Bm, precision=HI))
    z_all = jnp.stack(zs, axis=-2)                       # [p, ..., C, Z]
    y = y_in + jnp.einsum("p...cs,psm->p...cm", z_all, P, precision=HI)
    out = y.reshape(sig.shape)
    z_m1 = (jnp.einsum("p...s,pst->p...t", zs[-1], T2, precision=HI)
            + jnp.einsum("p...k,pks->p...s", b[..., C - 1, :], Bm2,
                         precision=HI))
    pick = lambda zz, o: jnp.stack([zz[..., 2 * j + o] for j in range(S)],
                                   axis=-1)
    return out, pick(z, 0), pick(z, 1), pick(z_m1, 0), pick(z_m1, 1)


def _allpass_chain_paired(sig, coef_pairs, y0s, x0s):
    """Run BOTH polyphase chains as one batched stack of first-order
    allpasses ``y = a*x + x_prev - a*y_prev``.

    ``sig`` carries a leading phase axis [2, ..., B]; ``coef_pairs`` is
    [n, 2] (section i's coefficient per phase); states are [2, ..., n].
    Both phases share section index i, so each section is a single
    double-width linrec1 scan instead of two — half the kernel launches
    of chaining the phases separately, with identical per-lane numerics.

    Wide voice banks (>= ``_MX_MIN_BATCH`` flattened lanes, block a
    multiple of ``_NC``) route to the matmul path instead (lifted whole-chain
    by default; see ``MX_CHAIN_IMPL``).
    """
    batch = 1
    for dsz in sig.shape[1:-1]:
        batch *= dsz
    N = sig.shape[-1]
    if batch >= _MX_MIN_BATCH and N % _NC == 0 and N >= 2:
        if MX_CHAIN_IMPL == "lifted":
            return _allpass_chain_lifted_mx(sig, coef_pairs, y0s, x0s)
        return _allpass_chain_paired_mx(sig, coef_pairs, y0s, x0s)
    new_y, new_x, new_y2, new_x2 = [], [], [], []
    bshape = (2,) + (1,) * (sig.ndim - 1)
    for i in range(coef_pairs.shape[0]):
        a = jnp.asarray(coef_pairs[i], jnp.float32).reshape(bshape)
        x_prev = jnp.concatenate([x0s[..., i : i + 1], sig[..., :-1]], axis=-1)
        b = a * sig + x_prev
        y = gscan.linrec1(jnp.broadcast_to(-a, sig.shape), b, y0s[..., i])
        new_x.append(sig[..., -1])
        new_y.append(y[..., -1])
        new_x2.append(sig[..., -2])
        new_y2.append(y[..., -2])
        sig = y
    return (sig, jnp.stack(new_y, axis=-1), jnp.stack(new_x, axis=-1),
            jnp.stack(new_y2, axis=-1), jnp.stack(new_x2, axis=-1))


def _pairs(coefs):
    c0, c1 = _split(coefs)
    return np.stack([np.asarray(c0, np.float32), np.asarray(c1, np.float32)], axis=1)


def upsample2(state: HalfbandState, x, coefs):
    """x[..., B] → [..., 2B] interpolated at twice the rate.

    Polyphase: even outputs = A0(x) (coefs 0,2,..), odd outputs = A1(x)
    (coefs 1,3,.. — the half-sample-delayed branch)."""
    sig = jnp.stack([x, x], axis=0)
    y0s = jnp.stack([state.ap0, state.ap1], axis=0)
    x0s = jnp.stack([state.ap0x, state.ap1x], axis=0)
    out, ny, nx, ny2, nx2 = _allpass_chain_paired(sig, _pairs(coefs), y0s, x0s)
    up = jnp.stack([out[0], out[1]], axis=-1).reshape(
        x.shape[:-1] + (2 * x.shape[-1],)
    )
    new_state = HalfbandState(ap0=ny[0], ap0x=nx[0], ap1=ny[1], ap1x=nx[1],
                              x1=state.x1,
                              ap0y2=ny2[0], ap0x2=nx2[0],
                              ap1y2=ny2[1], ap1x2=nx2[1])
    return new_state, up


def downsample2(state: HalfbandState, x, coefs):
    """x[..., 2B] → [..., B] decimated with the half-band filter."""
    even = x[..., 0::2]
    odd = x[..., 1::2]
    # phase alignment: the z^-1 branch processes the *previous* odd sample
    odd_d = jnp.concatenate([state.x1[..., None], odd[..., :-1]], axis=-1)
    sig = jnp.stack([even, odd_d], axis=0)
    y0s = jnp.stack([state.ap0, state.ap1], axis=0)
    x0s = jnp.stack([state.ap0x, state.ap1x], axis=0)
    out, ny, nx, ny2, nx2 = _allpass_chain_paired(sig, _pairs(coefs), y0s, x0s)
    down = 0.5 * (out[0] + out[1])
    new_state = HalfbandState(ap0=ny[0], ap0x=nx[0], ap1=ny[1], ap1x=nx[1],
                              x1=odd[..., -1],
                              ap0y2=ny2[0], ap0x2=nx2[0],
                              ap1y2=ny2[1], ap1x2=nx2[1])
    return new_state, down


class OversamplerState(NamedTuple):
    """Full 4x-capable state: two up stages + two down stages."""

    up1: HalfbandState
    up2: HalfbandState
    down2: HalfbandState
    down1: HalfbandState

    @staticmethod
    def init(batch=()) -> "OversamplerState":
        return OversamplerState(
            up1=HalfbandState.init(STAGE1, batch),
            up2=HalfbandState.init(STAGE2, batch),
            down2=HalfbandState.init(STAGE2, batch),
            down1=HalfbandState.init(STAGE1, batch),
        )


def process(state: OversamplerState, fn, x, mode: int = 4):
    """Evaluate ``fn`` at 1x/2x/4x around up/down half-band stages.

    mode: 1 (off), 2, or 4 (reference OversamplingMode, oversampler.rs:8-31).
    Returns ``(new_state, y)`` with y at the input rate.
    """
    if mode == 1:
        return state, fn(x)
    if mode == 2:
        u1, hi = upsample2(state.up1, x, STAGE1)
        shaped = fn(hi)
        d1, y = downsample2(state.down1, shaped, STAGE1)
        return state._replace(up1=u1, down1=d1), y
    if mode == 4:
        u1, hi2 = upsample2(state.up1, x, STAGE1)
        u2, hi4 = upsample2(state.up2, hi2, STAGE2)
        shaped = fn(hi4)
        d2, lo2 = downsample2(state.down2, shaped, STAGE2)
        d1, y = downsample2(state.down1, lo2, STAGE1)
        return OversamplerState(up1=u1, up2=u2, down2=d2, down1=d1), y
    raise ValueError(f"unsupported oversampling mode {mode}")


def stateful(state: OversamplerState, mode: int = 4):
    """Adapter for the effects' ``oversample(fn, x)`` hook.

    Returns ``(wrap, box)``: ``wrap`` evaluates fn through the up/down
    chain, threading the state through ``box['state']`` (trace-safe — the
    box only carries the traced output state to the caller)."""
    box = {"state": state}

    def wrap(fn, v):
        new_state, y = process(box["state"], fn, v, mode)
        box["state"] = new_state
        return y

    return wrap, box


def repeat_to_rate(param, v, block_size: int):
    """Hold an engine-rate per-sample parameter trajectory across each
    oversampled subsample group (the reference evaluates nonlinear curves
    2x/4x per engine sample with that sample's parameter values)."""
    factor = v.shape[-1] // block_size
    if factor <= 1 or jnp.ndim(param) == 0 or param.shape[-1] != block_size:
        return param
    return jnp.repeat(param, factor, axis=-1)
