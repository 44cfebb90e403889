"""Device-side WSOLA correlation search.

The coarse-to-fine normalized cross-correlation search
(src/mixer/wsola.rs:330-440) is a batched-dot problem: every candidate
offset's hop-length window against one reference tail.  Expressed as two
fixed-size einsums per stage —

    num[c] = cand[c, :] @ ref          (correlation)
    ce[c]  = einsum('ij,ij->i', cand, cand)   (candidate energy)

— plus an argmax, it runs on device with static shapes: the coarse stage
always evaluates ``NC = COARSE_STEPS + 1`` candidates and the fine stage a
fixed ``nf`` (invalid/padded candidates are masked to -inf so the argmax
ignores them, mirroring the host's variable-length ``np.arange`` ranges).

The kernel returns the chosen *indices* (coarse index, fine index, which
stage won), not positions: the host reconstructs the exact f64 candidate
value from its own ``lo_b + idx * stride`` arithmetic, so the downstream
hop state (analysis cursor, grain plans) is bit-identical to the host
search whenever the chosen indices match.  ``mixer/wsola.py`` keeps the
numpy search as the oracle; ``tests/test_wsola_device.py`` pins identical
hop choices on ramp/noise fixtures.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np


def _cubic_read(mono, pos, wrap: bool):
    """Catmull-Rom read at fractional positions (wsola.py _cubic_read_mono)."""
    L = mono.shape[0]
    pos = jnp.mod(pos, L) if wrap else jnp.clip(pos, 0.0, L - 1.0)
    idx = jnp.floor(pos).astype(jnp.int32)
    frac = (pos - idx).astype(jnp.float32)

    def tap(k):
        i = idx + k
        i = jnp.mod(i, L) if wrap else jnp.clip(i, 0, L - 1)
        return mono[i]

    p0, p1, p2, p3 = tap(-1), tap(0), tap(1), tap(2)
    a0 = -0.5 * p0 + 1.5 * p1 - 1.5 * p2 + 0.5 * p3
    a1 = p0 - 2.5 * p1 + 2.0 * p2 - 0.5 * p3
    a2 = -0.5 * p0 + 0.5 * p2
    return ((a0 * frac + a1) * frac + a2) * frac + p1


@functools.partial(jax.jit, static_argnames=("hop", "wrap", "nc", "nf"))
def search_hop(mono, ref, lo_b, hi_b, stride, step, max_start,
               win_lo, win_len, nc_valid, *, hop: int, wrap: bool,
               nc: int, nf: int):
    """One coarse-to-fine NCC search on device.

    Scalar args are f32; ``mono`` is the cached device (L+R) signal and
    ``ref`` the windowed previous-grain tail ``[hop]``.  ``nc_valid`` is
    the host's exact coarse candidate count (``len(np.arange(lo_b,
    hi_b + 1e-9, stride))`` in f64) — candidate validity must NOT be an
    f32 comparison against ``hi_b + 1e-9`` because the 1e-9 tie epsilon
    vanishes below the f32 ulp at audio-buffer offsets, silently dropping
    the final candidate the host keeps.  The fine count replicates
    ``np.arange``'s ceil semantics via a floor on the (small, exactly
    representable) fine span.  Returns int32 ``(coarse_idx, fine_idx,
    fine_won)``.
    """
    i = jnp.arange(hop, dtype=jnp.float32)
    eps = jnp.float32(np.finfo(np.float32).eps)
    re = jnp.dot(ref, ref, precision=jax.lax.Precision.HIGHEST)

    def scores(cands, valid):
        pos_v = jnp.clip(cands[:, None] + i[None, :] * step,
                         0.0, max_start + step)
        phys = (jnp.mod(win_lo + pos_v, win_len) if wrap
                else win_lo + pos_v)
        cand = _cubic_read(mono, phys.reshape(-1), wrap).reshape(pos_v.shape)
        num = jnp.dot(cand, ref, precision=jax.lax.Precision.HIGHEST)
        ce = jnp.einsum("ij,ij->i", cand, cand, precision=jax.lax.Precision.HIGHEST)
        ok = (ce > eps) & (re > eps)
        sc = jnp.where(ok, num / (jnp.sqrt(re) * jnp.sqrt(ce)), 0.0)
        return jnp.where(valid, sc, -jnp.inf)

    jc = jnp.arange(nc, dtype=jnp.float32)
    cand_c = lo_b + jc * stride
    sc = scores(cand_c, jc < nc_valid.astype(jnp.float32))
    ci = jnp.argmax(sc)
    best_c, best_sc = cand_c[ci], sc[ci]

    f_lo = jnp.maximum(best_c - stride, lo_b)
    f_hi = jnp.minimum(best_c + stride, hi_b)
    jf = jnp.arange(nf, dtype=jnp.float32)
    cand_f = f_lo + jf
    nf_valid = jnp.floor(f_hi - f_lo + 1e-9) + 1.0
    sf = scores(cand_f, jf < nf_valid)
    fi = jnp.argmax(sf)
    return (ci.astype(jnp.int32), fi.astype(jnp.int32),
            (sf[fi] > best_sc).astype(jnp.int32))
