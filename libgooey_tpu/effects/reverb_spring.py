"""Spring reverb: series allpass chain with global damped feedback.

Behavioral reference: src/effects/reverb.rs (235 LoC).  Per channel:

    signal = input + fb_prev
    signal = AP_1..AP_6(signal)            (Schroeder, prime delays, gains
                                            0.70..0.58; L/R use different
                                            prime tables for decorrelation)
    damp' = signal*(1-damping) + damp*damping
    fb    = damp' * (decay^0.4 * 0.95)     (used next sample)
    out   = input*(1-mix) + signal*mix

Block mapping: each allpass is affine in its input given its (>=127-sample-old)
delayed reads, so a whole chunk of C <= min-delay samples collapses: the
chain is ``signal -> alpha*signal + beta[n]`` with alpha = prod(gains), and
the only true recurrence is the damping one-pole coupled to the one-sample
feedback — a single first-order linear scan:

    d[n] = (damping[n] + (1-damping[n])*alpha*fb_gain[n-1]) * d[n-1]
         + (1-damping[n]) * (alpha*x[n] + beta[n])

State layout: instead of modulo ring buffers, the 12 allpass delay lines are
rows of one right-aligned history matrix ``hist[12, D]`` (D = max delay);
row i's last d_i columns hold the most recent d_i written values.  Per block
the matrix extends to a work buffer ``W[12, D+B]`` where every delayed read
and every write is a *static contiguous slice* — no gathers, no wraps.  The
block runs as a chunk loop of XLA slices + associative scans.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
import numpy as np

from libgooey_tpu.core.smoother import SmootherBank, smoothing_coeff
from libgooey_tpu.ops import scan as gscan

NUM_ALLPASSES = 6
DELAYS_44100_L = (131, 251, 389, 521, 617, 787)
DELAYS_44100_R = (127, 263, 397, 541, 631, 797)
GAINS = (0.70, 0.68, 0.65, 0.62, 0.60, 0.58)
MAX_FEEDBACK = 0.95

PARAM_DECAY, PARAM_MIX, PARAM_DAMPING = range(3)


class SpringState(NamedTuple):
    hist: jnp.ndarray  # [12, D] right-aligned delay-line histories (L then R)
    fb: jnp.ndarray    # [2] feedback sample (includes its feedback gain)
    damp: jnp.ndarray  # [2] damping filter state
    smooth: SmootherBank  # [2, 3]: decay, mix, damping


def delay_lengths(sample_rate: float):
    scale = sample_rate / 44100.0
    mk = lambda tbl: tuple(max(int(d * scale), 1) for d in tbl)
    return mk(DELAYS_44100_L), mk(DELAYS_44100_R)


def init_state(sample_rate: float, decay: float = 0.5, mix: float = 0.3,
               damping: float = 0.5) -> SpringState:
    dl, dr = delay_lengths(sample_rate)
    D = max(dl + dr)
    init = np.array(
        [[np.clip(decay, 0, 1), np.clip(mix, 0, 1), np.clip(damping, 0, 1)]] * 2,
        np.float32,
    )
    return SpringState(
        hist=jnp.zeros((2 * NUM_ALLPASSES, D), jnp.float32),
        fb=jnp.zeros(2, jnp.float32),
        damp=jnp.zeros(2, jnp.float32),
        smooth=SmootherBank.init(init),
    )


def chunk_size(sample_rate: float, block_size: int) -> int:
    """Largest divisor of the block not exceeding the min allpass delay."""
    min_delay = min(delay_lengths(sample_rate)[1])
    c = block_size
    while c > min_delay:
        c //= 2
    return max(c, 1)


def process_block(
    state: SpringState,
    x,           # [2, B]
    targets,     # [3]: decay, mix, damping
    *,
    sample_rate: float,
):
    """One block of the stereo spring reverb → ``(new_state, out[2, B])``."""
    B = x.shape[-1]
    C = chunk_size(sample_rate, B)
    n_chunks = B // C
    x = jnp.where(jnp.isfinite(x), x, 0.0)

    coeff = smoothing_coeff(sample_rate)
    bank = state.smooth.with_targets(
        jnp.broadcast_to(jnp.asarray(targets, jnp.float32), (2, 3))
    )
    powers = jnp.power(np.float32(1.0 - coeff), jnp.arange(1, B + 1, dtype=jnp.float32))

    def traj(idx):
        tgt = bank.target[:, idx, None]
        delta = (bank.current[:, idx] - bank.target[:, idx])[:, None]
        d = delta * powers
        return tgt + jnp.where(jnp.abs(d) < 1e-4, 0.0, d)

    decay_t = traj(PARAM_DECAY)
    mix_t = traj(PARAM_MIX)
    damping_t = traj(PARAM_DAMPING)
    fb_gain_t = jnp.power(jnp.maximum(decay_t, 0.0), 0.4) * MAX_FEEDBACK

    dl, dr = delay_lengths(sample_rate)
    delays = dl + dr
    D = state.hist.shape[-1]
    alpha = float(np.prod(GAINS))

    # Whole-block recurrence coefficients (the per-chunk beta terms are
    # delay-line-dependent and computed inside the chunk loop / kernel).
    # d[n] = A[n]*d[n-1] + (1-damping[n])*(alpha*xeff[n] + beta[n]); the
    # block-carried fb (reverb.rs stores fb WITH its gain already applied)
    # enters additively at n=0, so A[0] has no feedback term and
    # xeff[0] = x[0] + fb0.  fbgp[n] = fb_gain[n-1] (0 at n=0) turns the
    # scanned d-trajectory back into per-sample chain inputs.
    p2 = 1.0 - damping_t
    fbgp = jnp.concatenate(
        [jnp.zeros((2, 1), jnp.float32), fb_gain_t[:, :-1]], axis=-1
    )
    A = damping_t + p2 * alpha * fbgp
    A = A.at[:, 0].set(damping_t[:, 0])
    xeff = x.astype(jnp.float32).at[:, 0].add(state.fb)

    W = jnp.concatenate(
        [state.hist, jnp.zeros((2 * NUM_ALLPASSES, B), jnp.float32)], axis=-1
    )
    damp0 = state.damp
    wets = []
    for c in range(n_chunks):
        s = c * C
        sl = slice(s, s + C)
        delayed = [
            jnp.stack([
                W[i, D + s - delays[i]:D + s - delays[i] + C],
                W[NUM_ALLPASSES + i,
                  D + s - delays[NUM_ALLPASSES + i]:
                  D + s - delays[NUM_ALLPASSES + i] + C],
            ])
            for i in range(NUM_ALLPASSES)
        ]
        beta = jnp.zeros((2, C), jnp.float32)
        for g, dly in zip(GAINS, delayed):
            beta = g * beta + (1.0 - g * g) * dly
        Bv = p2[:, sl] * (alpha * xeff[:, sl] + beta)
        d_traj = gscan.linrec1(A[:, sl], Bv, damp0)
        d_prev = jnp.concatenate([damp0[:, None], d_traj[:, :-1]], axis=-1)
        sig = xeff[:, sl] + fbgp[:, sl] * d_prev
        for i, (g, dly) in enumerate(zip(GAINS, delayed)):
            v = sig - g * dly
            W = W.at[i, D + s:D + s + C].set(v[0])
            W = W.at[NUM_ALLPASSES + i, D + s:D + s + C].set(v[1])
            sig = g * v + dly
        wets.append(sig)
        damp0 = d_traj[:, -1]
    wet = jnp.concatenate(wets, axis=-1)
    new_hist = W[:, B:B + D]
    d_last = damp0

    out = x * (1.0 - mix_t) + wet * mix_t
    new_state = SpringState(
        hist=new_hist,
        fb=fb_gain_t[:, -1] * d_last,
        damp=d_last,
        smooth=SmootherBank(
            current=jnp.stack(
                [decay_t[:, -1], mix_t[:, -1], damping_t[:, -1]], axis=-1
            ),
            target=bank.target,
        ),
    )
    return new_state, out
