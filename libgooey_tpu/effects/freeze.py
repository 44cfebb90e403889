"""Block-granular state freezes for bypass branches.

The reference's bypass paths are early returns that freeze ALL DSP state
(saturation.rs:230-232, waveshaper.rs:55-57, tilt_filter.rs:114-115,
bass.rs:846).  Per-sample recurrences here freeze with ``jnp.where`` masks
on their coefficients (DC blockers, envelope followers), but the polyphase
half-band oversampler chains and the tilt SVF owe their speed to
constant-coefficient formulations (Toeplitz matmuls / single scans)
that cannot freeze per sample.

This module provides the next-best exact semantics: when EVERY sample of a
block is bypassed, the caller swaps the freshly-computed state back for the
incoming one — so any bypass span longer than a block holds state exactly
like the reference's early return, and only the boundary blocks (where the
smoothed bypass condition crosses mid-block) deviate.  That residual
deviation is pinned by tests/test_state_freeze.py.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def hold_where(held, old_tree, new_tree):
    """Per-row state select: ``held`` is a boolean mask over the leading
    (channel/voice) axis; held rows keep ``old_tree``'s leaves."""
    held = jnp.asarray(held)

    def sel(o, n):
        m = held.reshape(held.shape + (1,) * (n.ndim - held.ndim))
        return jnp.where(m, o, n)

    return jax.tree_util.tree_map(sel, old_tree, new_tree)


def traj_all_below(cur, tgt, q, block_size: int, thresh):
    """Whether a settle-snapped one-pole smoother trajectory stays below
    ``thresh`` for the whole block.

    The trajectory ``tgt + snap(delta * q^n)`` is monotone in n, so the
    block maximum is at the first or last sample.
    """
    delta = cur - tgt
    d1 = delta * q
    dB = delta * q ** jnp.float32(block_size)
    first = tgt + jnp.where(jnp.abs(d1) < 1e-4, 0.0, d1)
    last = tgt + jnp.where(jnp.abs(dB) < 1e-4, 0.0, dB)
    return (first < thresh) & (last < thresh)
