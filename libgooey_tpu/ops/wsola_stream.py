"""Device-resident WSOLA streaming: the hop loop as one ``lax.scan``.

Behavioral reference: src/mixer/wsola.rs (synthesize_hop / search loops,
rs:120-330) — the same 20 ms hop scheduler, coarse-to-fine NCC search and
COLA overlap-add as ``mixer/wsola.WsolaHost``, but with the *entire*
per-hop loop (search, grain reads, tail update, overlap-add) running on
device inside a scan.  The per-block host path pays one host↔device
round trip per hop (the search result feeds the next hop's reference
tail); this path batches ``n_hops`` hops into ONE dispatch, so offline
PreservePitch renders are compute-bound instead of round-trip-bound.

Design notes:

* **Positions are (integer, fraction) f32 pairs.**  The reference keeps
  f64 hop cursors on the host.  The device path stays in f32, but every carried
  position here is ``int + frac`` with the integer part exact in f32 (<
  2^24) and the fraction in [0, 1): per-hop rounding is ≤ ulp(2) ≈
  2.4e-7 samples, so a 1000-hop render drifts ~1e-4 samples vs the f64
  host scheduler — far below the ~14-sample candidate spacing.
* **All candidate/grain reads are `gather_read_cubic` rows.**  A
  candidate row reads ``cubic(mono, cand + i*step)`` — the granulator's
  "fractional start + uniform step" shape — over a per-hop union window
  sliced from the (edge- or wrap-padded) buffer.  The union
  covers every coarse/fine candidate window and the chosen grain
  (anchor = floor(lo_b); width is static).
* The previous grain's windowed second half (stereo, for overlap-add)
  and its windowed mono tail (the NCC reference) are *carried* through
  the scan instead of re-read, so each hop reads only its own union.

Known deviations vs the host scheduler (documented; the host path stays
the reference-mirroring oracle and the default for interactive blocks):

* score-window positions are NOT clamped at ``max_start + step``; for
  candidates near the window end the host flattens the window tail to a
  constant-position read while this path reads the true samples (both
  are valid similarity measures; choices can differ near the loop end);
* read positions ``p0 + step*n`` are f32 (~1.2e-4-sample error at
  grain length), so scores and audio differ from the f64 host by ~1e-4
  absolute — ties in the argmax can resolve differently on
  self-similar (periodic) material;
* the coarse candidate *count* replicates ``np.arange``'s f64 ceil
  semantics via ``floor(q + 1e-5) + 1`` — a genuine fractional span
  within 1e-5 of an integer can count one candidate differently.

`tests/test_wsola_stream.py` pins this path against the host scheduler
(identical hop starts, audio to ≤1e-3) and its own batch-boundary
continuity.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np


COARSE_STEPS = 64
NC = COARSE_STEPS + 1
_EPS = float(np.finfo(np.float32).eps)
#: the correlation search compares scores, so a TF32 rounding could flip
#: which hop wins
HIGHEST = jax.lax.Precision.HIGHEST


def gather_read_cubic(buffer, p0, step, *, B: int):
    """Cubic (Catmull-Rom) reads of ``buffer`` at ``p0[g] + step[g] * n``
    for ``n < B``: ``[G, B]`` rows, positions clamped to the buffer."""
    L = buffer.shape[0]
    n = jnp.arange(B, dtype=jnp.float32)
    pos = jnp.clip(p0[:, None] + step[:, None] * n[None, :], 0.0, L - 1.0)
    i1 = jnp.floor(pos).astype(jnp.int32)
    frac = pos - jnp.floor(pos)
    p0_ = buffer[jnp.clip(i1 - 1, 0, L - 1)]
    p1 = buffer[i1]
    p2 = buffer[jnp.clip(i1 + 1, 0, L - 1)]
    p3 = buffer[jnp.clip(i1 + 2, 0, L - 1)]
    a0 = -0.5 * p0_ + 1.5 * p1 - 1.5 * p2 + 0.5 * p3
    a1 = p0_ - 2.5 * p1 + 2.0 * p2 - 0.5 * p3
    a2 = -0.5 * p0_ + 0.5 * p2
    return ((a0 * frac + a1) * frac + a2) * frac + p1


class StreamConfig(NamedTuple):
    """Trace-static per-batch WSOLA parameters (host-computed in f64)."""

    hop: int
    win_n: int
    step: float        # source step per output sample (sr_ratio * speed)
    hopw_i: float      # hop_span * warp, split int/frac
    hopw_f: float
    rad: float         # search radius (integer-valued)
    ms_i: float        # max_start split
    ms_f: float
    wl_i: float        # floor(win_lo) / frac(win_lo)
    wl_f: float
    L: int             # window length (== buffer length, loop_channel.window)
    wraps: bool
    U: int             # union-window width
    nf: int            # fine candidate capacity
    hopB: int          # hop padded to a power-of-two read length
    grainB: int        # win_n padded likewise


def make_config(engine_sr: float, buffer_sr: float, L: int, win_lo: float,
                span: float, wraps: bool, speed: float,
                warp: float) -> StreamConfig | None:
    """Build the static config, or None when streaming can't apply
    (degenerate window, buffer shorter than the union window)."""
    sr = max(engine_sr, 1.0)
    hop = max(int(round(20.0 / 1000.0 * sr)), 1)
    win_n = 2 * hop
    ratio = buffer_sr / sr
    step = max(ratio * max(speed, 0.0), 1e-6)
    grain_span = (win_n - 1.0) * step + 1.0
    max_start = span - grain_span
    if max_start <= 0.0:
        return None
    radius = max(round(10.0 / 1000.0 * buffer_sr), 1.0)
    U = int(2 * radius + grain_span + 24)
    if wraps and L < U + 8:
        return None
    hop_span_warp = hop * step * max(warp, 0.0)
    stride_max = max(2.0 * radius / COARSE_STEPS, 1.0)
    nf = 2 * int(np.ceil(stride_max)) + 3

    def _pad(n):
        return 256 * max(1, -(-n // 256)) if n > 128 else 128

    return StreamConfig(
        hop=hop, win_n=win_n, step=float(step),
        hopw_i=float(math.floor(hop_span_warp)),
        hopw_f=float(hop_span_warp - math.floor(hop_span_warp)),
        rad=float(radius),
        ms_i=float(math.floor(max_start)),
        ms_f=float(max_start - math.floor(max_start)),
        wl_i=float(math.floor(win_lo)),
        wl_f=float(win_lo - math.floor(win_lo)),
        L=int(L), wraps=bool(wraps), U=U, nf=nf,
        hopB=_pad(hop), grainB=_pad(win_n),
    )


def pad_buffer(rows, cfg: StreamConfig):
    """``[R, L] -> [R, 4 + L + U]`` with the host tap semantics baked in:
    wrap windows get wrap padding (taps mod L), non-wrap get edge holds
    (taps clamped to [0, L-1]).  Flat index ``p + 4`` reads sample ``p``."""
    if cfg.wraps:
        return jnp.concatenate([rows[:, -4:], rows, rows[:, : cfg.U]], axis=1)
    return jnp.concatenate(
        [jnp.repeat(rows[:, :1], 4, axis=1), rows,
         jnp.repeat(rows[:, -1:], cfg.U, axis=1)], axis=1)


# --- (integer, fraction) scalar pairs ---------------------------------------

def _norm(i, f):
    k = jnp.floor(f)
    return i + k, f - k


def _add(a, b):
    return _norm(a[0] + b[0], a[1] + b[1])


def _sub(a, b):
    return _norm(a[0] - b[0], a[1] - b[1])


def _lt(a, b):
    return (a[0] < b[0]) | ((a[0] == b[0]) & (a[1] < b[1]))


def _sel(c, a, b):
    return jnp.where(c, a[0], b[0]), jnp.where(c, a[1], b[1])


def _pmax(a, b):
    return _sel(_lt(a, b), b, a)


def _pmin(a, b):
    return _sel(_lt(a, b), a, b)


# --- the hop scan ------------------------------------------------------------

def _hop_once(carry, P3, w1, w2, d, cfg: StreamConfig):
    """One WSOLA hop for one channel.

    ``d`` maps the per-channel NUMERIC parameters (step, hopw_i/f, rad,
    ms_i/f, wl_i/f, L) to scalars — python floats when traced statically
    (:func:`stream_hops`, numerics identical to round 4) or 0-d traced
    arrays from the channel-batched vmap path (:func:`stream_hops_batched`).
    ``cfg`` supplies only the STRUCTURAL statics (hop, win_n, U, nf,
    hopB, grainB, wraps).
    """
    f32 = jnp.float32
    _c = lambda v: jnp.asarray(v, jnp.float32)
    step = _c(d["step"])
    eps = f32(_EPS)
    ZERO = (f32(0.0), f32(0.0))
    HOPW = (_c(d["hopw_i"]), _c(d["hopw_f"]))
    RAD = (_c(d["rad"]), f32(0.0))
    MS = (_c(d["ms_i"]), _c(d["ms_f"]))
    jc = jnp.arange(NC, dtype=jnp.float32)
    jf = jnp.arange(cfg.nf, dtype=jnp.float32)
    row_off = jnp.arange(3, dtype=jnp.float32) * cfg.U

    def read_windows(uflat, p0s, B):
        r = gather_read_cubic(uflat, p0s,
                             jnp.broadcast_to(step, p0s.shape), B=B)
        return r[:, : cfg.hop]

    def scores(uflat, p0s, valid, ref, re):
        cand = read_windows(uflat, p0s, cfg.hopB)
        num = jnp.dot(cand, ref, precision=HIGHEST)
        ce = jnp.einsum("ij,ij->i", cand, cand, precision=HIGHEST)
        ok = (ce > eps) & (re > eps)
        sc = jnp.where(ok, num / (jnp.sqrt(re) * jnp.sqrt(ce)), 0.0)
        return jnp.where(valid, sc, -jnp.inf)

    cur, have_prev, ref_tail, ptail = carry
    raw = _add(cur, HOPW)
    wrapped = _lt(MS, raw)  # raw_target > max_start (max_start > 0 here)
    # host: search_center = 0 if wrapped else max(raw_target, 0) — the
    # cursor can sit below the loop window (negative virtual coords)
    ctr = _sel(wrapped, ZERO, _pmax(raw, ZERO))
    hp_cur = have_prev & ~wrapped

    lo = _pmax(_sub(ctr, RAD), ZERO)
    hi = _pmin(_add(ctr, RAD), MS)
    search_ok = _lt(lo, hi)

    anchor = lo[0]
    sb = _c(d["wl_i"]) + anchor
    if cfg.wraps:
        L = _c(d["L"])
        sb = jnp.where(sb >= L, sb - L, sb)
    uwin3 = jax.lax.dynamic_slice(
        P3, (0, sb.astype(jnp.int32)), (3, cfg.U))
    uflat = uwin3.reshape(-1)

    def rel(p):
        return (p[0] - anchor) + (p[1] + (_c(d["wl_f"]) + f32(4.0)))

    # coarse stage
    dd = (hi[0] - lo[0]) + (hi[1] - lo[1])
    stride = jnp.maximum(dd / COARSE_STEPS, 1.0)
    q = dd / stride
    nc_valid = jnp.floor(q + 1e-5) + 1.0
    base = rel(lo)
    re = jnp.dot(ref_tail, ref_tail, precision=HIGHEST)
    sc = scores(uwin3[0], base + jc * stride, jc < nc_valid,
                ref_tail, re)
    ci = jnp.argmax(sc)
    best_c = jc[ci] * stride            # offset from lo

    # fine stage (1-sample steps around the coarse winner)
    f_lo = jnp.maximum(best_c - stride, 0.0)
    f_hi = jnp.minimum(best_c + stride, dd)
    nf_valid = jnp.floor(f_hi - f_lo + 1e-9) + 1.0
    sf = scores(uwin3[0], base + f_lo + jf, jf < nf_valid,
                ref_tail, re)
    fi = jnp.argmax(sf)
    best_off = jnp.where(sf[fi] > sc[ci], f_lo + jf[fi], best_c)

    searched = _norm(lo[0], lo[1] + best_off)
    best = _sel(hp_cur & search_ok, searched, ctr)

    # the chosen grain: [3, win_n] = mono, left, right
    g3 = gather_read_cubic(
        uflat, rel(best) + row_off,
        jnp.broadcast_to(step, (3,)), B=cfg.grainB)[:, : cfg.win_n]
    y = g3[1:3, : cfg.hop] * w1[None, :] + jnp.where(hp_cur, 1.0, 0.0) * ptail
    new_ref = g3[0, cfg.hop:] * w2
    new_ptail = g3[1:3, cfg.hop:] * w2[None, :]

    out = (best[0], best[1], hp_cur, y)
    return (best, jnp.ones((), bool), new_ref, new_ptail), out


def _static_dyn(cfg: StreamConfig):
    return dict(step=float(cfg.step), hopw_i=float(cfg.hopw_i),
                hopw_f=float(cfg.hopw_f), rad=float(cfg.rad),
                ms_i=float(cfg.ms_i), ms_f=float(cfg.ms_f),
                wl_i=float(cfg.wl_i), wl_f=float(cfg.wl_f),
                L=float(cfg.L))


def stream_hops(P3, w1, w2, state, *, n_hops: int, cfg: StreamConfig):
    """Run ``n_hops`` WSOLA hops on device (single channel, static cfg).

    ``P3``: ``[3, 4+L+U]`` padded rows (mono = L+R, left, right) from
    :func:`pad_buffer`.  ``w1``/``w2``: the COLA window halves ``[hop]``.
    ``state``: ``(cur_i, cur_f, have_prev, ref_tail[hop],
    ptail[2, hop])`` — virtual cursor pair, whether a previous grain
    exists, its windowed mono tail (NCC reference) and windowed stereo
    second half (overlap-add partner).

    Returns ``(state', bests_i[n], bests_f[n], hps[n], ys[n, 2, hop])``.
    """
    d = _static_dyn(cfg)

    def body(carry, _):
        return _hop_once(carry, P3, w1, w2, d, cfg)

    carry, (bi, bf, hps, ys) = jax.lax.scan(body, state, None, length=n_hops)
    return carry, bi, bf, hps, ys


def _hop_once_batched(carry, P3c, w1, w2, d, cfg: StreamConfig):
    """One hop for C channels at once — `_hop_once`'s math with an
    explicit leading channel axis.

    The window reads are CHANNEL-FLATTENED into single
    `gather_read_cubic` calls over the concatenated union windows;
    everything else is elementwise on [C] or batched einsums.  ``d``: dict of [C] f32 per-channel parameters.
    """
    f32 = jnp.float32
    C = P3c.shape[0]
    step = d["step"]                                       # [C]
    eps = f32(_EPS)
    zc = jnp.zeros((C,), f32)
    ZERO = (zc, zc)
    HOPW = (d["hopw_i"], d["hopw_f"])
    RAD = (d["rad"], zc)
    MS = (d["ms_i"], d["ms_f"])
    jc = jnp.arange(NC, dtype=jnp.float32)
    jf = jnp.arange(cfg.nf, dtype=jnp.float32)
    row_off = jnp.arange(3, dtype=jnp.float32) * cfg.U     # [3]
    chan_off = (jnp.arange(C, dtype=jnp.float32) * (3 * cfg.U))  # [C]

    cur, have_prev, ref_tail, ptail = carry
    raw = _add(cur, HOPW)
    wrapped = _lt(MS, raw)
    ctr = _sel(wrapped, ZERO, _pmax(raw, ZERO))
    hp_cur = have_prev & ~wrapped

    lo = _pmax(_sub(ctr, RAD), ZERO)
    hi = _pmin(_add(ctr, RAD), MS)
    search_ok = _lt(lo, hi)

    anchor = lo[0]                                         # [C]
    sb = d["wl_i"] + anchor
    if cfg.wraps:
        sb = jnp.where(sb >= d["L"], sb - d["L"], sb)
    uwin3 = jax.vmap(
        lambda p3, s: jax.lax.dynamic_slice(p3, (0, s), (3, cfg.U))
    )(P3c, sb.astype(jnp.int32))                           # [C, 3, U]
    uflat = uwin3.reshape(-1)                              # [C*3*U]

    def rel(p):
        return (p[0] - anchor) + (p[1] + (d["wl_f"] + f32(4.0)))

    def scores(p0s, valid, nrows):
        """p0s [C, n] channel-relative mono starts -> NCC scores [C, n]."""
        starts = (p0s + chan_off[:, None]).reshape(-1)
        steps = jnp.broadcast_to(step[:, None], p0s.shape).reshape(-1)
        cand = gather_read_cubic(uflat, starts, steps, B=cfg.hopB)
        cand = cand[:, : cfg.hop].reshape(C, nrows, cfg.hop)
        num = jnp.einsum("cnh,ch->cn", cand, ref_tail, precision=HIGHEST)
        ce = jnp.einsum("cnh,cnh->cn", cand, cand, precision=HIGHEST)
        ok = (ce > eps) & (re > eps)[:, None]
        sc = jnp.where(ok, num / (jnp.sqrt(re)[:, None] * jnp.sqrt(ce)), 0.0)
        return jnp.where(valid, sc, -jnp.inf)

    # coarse stage
    dd = (hi[0] - lo[0]) + (hi[1] - lo[1])                 # [C]
    stride = jnp.maximum(dd / COARSE_STEPS, 1.0)
    q = dd / stride
    nc_valid = jnp.floor(q + 1e-5) + 1.0
    base = rel(lo)                                         # [C]
    re = jnp.einsum("ch,ch->c", ref_tail, ref_tail, precision=HIGHEST)
    sc = scores(base[:, None] + jc[None, :] * stride[:, None],
                jc[None, :] < nc_valid[:, None], NC)
    ci = jnp.argmax(sc, axis=-1)                           # [C]
    best_c = jc[ci] * stride

    # fine stage
    f_lo = jnp.maximum(best_c - stride, 0.0)
    f_hi = jnp.minimum(best_c + stride, dd)
    nf_valid = jnp.floor(f_hi - f_lo + 1e-9) + 1.0
    sf = scores(base[:, None] + f_lo[:, None] + jf[None, :],
                jf[None, :] < nf_valid[:, None], cfg.nf)
    fi = jnp.argmax(sf, axis=-1)
    cix = jnp.arange(C)
    best_off = jnp.where(sf[cix, fi] > sc[cix, ci], f_lo + jf[fi], best_c)

    searched = _norm(lo[0], lo[1] + best_off)
    best = _sel(hp_cur & search_ok, searched, ctr)

    # chosen grains: one call over [C*3] rows
    gstarts = (rel(best)[:, None] + row_off[None, :]
               + chan_off[:, None])                        # [C, 3]
    gsteps = jnp.broadcast_to(step[:, None], (C, 3)).reshape(-1)
    g3 = gather_read_cubic(uflat, gstarts.reshape(-1), gsteps,
                          B=cfg.grainB)[:, : cfg.win_n].reshape(C, 3,
                                                                cfg.win_n)
    y = (g3[:, 1:3, : cfg.hop] * w1[None, None, :]
         + jnp.where(hp_cur, 1.0, 0.0)[:, None, None] * ptail)
    new_ref = g3[:, 0, cfg.hop:] * w2[None, :]
    new_ptail = g3[:, 1:3, cfg.hop:] * w2[None, None, :]

    out = (best[0], best[1], hp_cur, y)
    return (best, jnp.ones((C,), bool), new_ref, new_ptail), out


def stream_hops_batched(P3c, w1, w2, state, n_active, dyn, *, n_hops: int,
                        cfg: StreamConfig):
    """Run up to ``n_hops`` hops for C channels in ONE scan.

    ``P3c``: ``[C, 3, W]`` padded rows (channels padded to a shared
    ``4 + Lmax + U``); ``state``: the per-channel state tuple with a
    leading C axis on every leaf; ``n_active [C]``: each channel's true
    hop count (hops past it keep the carry frozen and produce don't-care
    ``ys`` the caller never slices into); ``dyn``: dict of ``[C]`` f32
    arrays (step/hopw/rad/ms/wl/L).  ``cfg`` carries the shared
    structural statics — ``hop``/``win_n``/``hopB``/``grainB`` are
    engine-rate constants, ``U``/``nf`` the batch maxima, ``wraps`` must
    be uniform (callers group channels by wrap-ness).

    Per-channel math mirrors `_hop_once` (`_hop_once_batched`); only the
    batching axis and the channel-flattened reads are new.
    """
    def body(carry, h):
        new_carry, out = _hop_once_batched(carry, P3c, w1, w2, dyn, cfg)
        keep = h < n_active                                    # [C]

        def sel(n, o):
            k = keep.reshape((keep.shape[0],) + (1,) * (n.ndim - 1))
            return jnp.where(k, n, o)

        merged = jax.tree_util.tree_map(sel, new_carry, carry)
        return merged, out

    carry, (bi, bf, hps, ys) = jax.lax.scan(
        body, state, jnp.arange(n_hops))
    return carry, bi, bf, hps, ys


def state_tuple(state):
    cur_i, cur_f, have_prev, ref_tail, ptail = state
    return ((jnp.asarray(cur_i, jnp.float32), jnp.asarray(cur_f, jnp.float32)),
            jnp.asarray(have_prev, bool),
            jnp.asarray(ref_tail, jnp.float32),
            jnp.asarray(ptail, jnp.float32))
