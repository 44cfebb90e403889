"""Time-based ADSR envelopes as pure functions.

The reference's `Envelope` (src/envelope.rs) is *time-based*: amplitude is a
closed-form function of seconds-since-trigger, not a per-sample recursion.
That maps perfectly onto a batched device: we evaluate the whole ``[V, B]`` block of
elapsed times in one vectorized expression — no scan needed.

Phases (reference src/envelope.rs:154-210):

* attack  (0 ≤ e < A):      ``curve_a(e / A)``
* decay   (A ≤ e < A + D):  ``1 − (1 − S) * curve_d((e − A) / D)``
* sustain (e ≥ A + D):      ``S`` — if S == 0 the envelope auto-releases the
  first tick past A+D, which yields 0 thereafter (drum behavior).
* release (manual): linear ramp of the pre-release amplitude over R seconds.

Curves (src/envelope.rs:21-27): Linear, or Exponential(c) = progress**clamp(c,
0.1, 10).  We represent "linear" as c == 1.0 (identical math), so a single
vectorized power covers both; the reference's Linear fast-path is a CPU
optimization, not a semantic difference.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp


class ADSR(NamedTuple):
    """ADSR configuration as (broadcastable) arrays — typically per-voice [V].

    Times in seconds.  Reference clamps attack/decay/release to >= 1 ms
    (src/envelope.rs:34-38) — callers construct via :func:`adsr` to apply it.
    """

    attack: jnp.ndarray
    decay: jnp.ndarray
    sustain: jnp.ndarray
    release: jnp.ndarray
    attack_curve: jnp.ndarray  # power-curve exponent, 1.0 == linear
    decay_curve: jnp.ndarray


def adsr(attack, decay, sustain, release, attack_curve=1.0, decay_curve=1.0):
    """Build an :class:`ADSR`, applying the reference's 1 ms minimums."""
    return ADSR(
        attack=jnp.maximum(jnp.asarray(attack, jnp.float32), 0.001),
        decay=jnp.maximum(jnp.asarray(decay, jnp.float32), 0.001),
        sustain=jnp.clip(jnp.asarray(sustain, jnp.float32), 0.0, 1.0),
        release=jnp.maximum(jnp.asarray(release, jnp.float32), 0.001),
        attack_curve=jnp.asarray(attack_curve, jnp.float32),
        decay_curve=jnp.asarray(decay_curve, jnp.float32),
    )


def apply_curve(progress, c):
    """EnvelopeCurve::apply — ``progress ** clamp(c, 0.1, 10)``.

    src/envelope.rs:21-27.  ``c == 1`` reproduces Linear exactly.
    """
    c = jnp.clip(c, 0.1, 10.0)
    # progress is within [0, 1]; power of a non-negative base is safe.
    return jnp.power(jnp.maximum(progress, 0.0), c)


def amplitude(env: ADSR, elapsed, release_elapsed=None):
    """Envelope amplitude for ``elapsed`` seconds since trigger.

    ``elapsed`` may be any shape (e.g. ``[V, B]``); env fields broadcast
    against it (e.g. ``[V, 1]``).  Negative elapsed (not yet triggered)
    yields 0.

    ``release_elapsed``: seconds since a *manual* release event, or None for
    the un-released path.  For sustain == 0 envelopes (all drums) the
    reference auto-releases at the end of decay, producing 0 from then on —
    which this closed form reproduces without tracking a release timestamp.
    """
    a, d, s = env.attack, env.decay, env.sustain
    attack_amp = apply_curve(elapsed / a, env.attack_curve)
    decay_prog = apply_curve((elapsed - a) / d, env.decay_curve)
    decay_amp = 1.0 - (1.0 - s) * decay_prog

    in_attack = elapsed < a
    in_decay = elapsed < a + d
    held = jnp.where(in_attack, attack_amp, jnp.where(in_decay, decay_amp, s))
    held = jnp.where(elapsed >= 0.0, held, 0.0)

    if release_elapsed is None:
        return held

    # Manual release: amplitude frozen at release start, ramped linearly to 0
    # over `release` seconds (src/envelope.rs:163-189).  The amplitude at
    # release start is the held value evaluated at (elapsed - release_elapsed).
    pre = amplitude(env, elapsed - release_elapsed)
    rel_prog = release_elapsed / env.release
    released = pre * jnp.maximum(1.0 - rel_prog, 0.0)
    return jnp.where(release_elapsed > 0.0, released, held)


def drum_active(env: ADSR, elapsed):
    """Whether a sustain-0 envelope still has signal (attack+decay window)."""
    return (elapsed >= 0.0) & (elapsed < env.attack + env.decay)
