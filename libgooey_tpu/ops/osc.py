"""Time-based oscillators over ``[V, B]`` blocks.

The reference's oscillators are *time-based* (src/gen/oscillator.rs:242-255):
every tick recomputes the waveform from samples-since-trigger, with the
*current* frequency — i.e. ``sin(2*pi*f[n]*t[n])`` with no phase integration.
Pitch envelopes therefore modulate the instantaneous argument, not a phase
accumulator.  We reproduce exactly that: each waveform is a pure function of
``(sample_index_since_trigger, freq[n])``, fully parallel over voices and
samples.

``sample_index`` below is float samples since trigger (the reference's
``current_sample_index``); frequency arrays broadcast against it.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from libgooey_tpu.core import rng

TWO_PI = float(2.0 * np.pi)


def sine(sample_index, freq, sample_rate):
    """``sin(idx * f * 2pi / sr)`` — src/gen/oscillator.rs:41-45."""
    return jnp.sin(sample_index * freq * (TWO_PI / sample_rate))


def ring_mod(sample_index, freq, mod_freq, sample_rate):
    """Carrier sine × modulator sine (src/gen/oscillator.rs:181-185)."""
    return sine(sample_index, freq, sample_rate) * sine(
        sample_index, mod_freq, sample_rate
    )


def noise(sample_index, seed=rng.DEFAULT_SEED):
    """Hash-of-sample-index noise (src/gen/oscillator.rs:187-196).

    The reference hashes the integer sample index; the hash differs (see
    core.rng) but the contract — deterministic white noise that restarts on
    trigger — is identical.
    """
    return rng.white_from_sample_index(jnp.floor(sample_index).astype(jnp.int32), seed)


def poly_blep(t, dt):
    """2-sample polynomial step correction (src/gen/polyblep.rs:8-20)."""
    dt = jnp.maximum(dt, 1e-12)
    early = t / dt
    late = (t - 1.0) / dt
    return jnp.where(
        t < dt,
        2.0 * early - early * early - 1.0,
        jnp.where(t > 1.0 - dt, late * late + 2.0 * late + 1.0, 0.0),
    )


def _phase(sample_index, freq, sample_rate):
    """Phase in [0,1) and per-sample increment (oscillator.rs:153-157)."""
    inc = freq / sample_rate
    phase = jnp.mod(sample_index * inc, 1.0)
    return phase, inc


def saw_blep(sample_index, freq, sample_rate):
    """Band-limited saw: naive ramp minus one blep (polyblep.rs:25-29)."""
    phase, inc = _phase(sample_index, freq, sample_rate)
    return (2.0 * phase - 1.0) - poly_blep(phase, inc)


def square_blep(sample_index, freq, sample_rate):
    """Band-limited square: bleps at both edges (polyblep.rs:34-40)."""
    phase, inc = _phase(sample_index, freq, sample_rate)
    naive = jnp.where(phase < 0.5, 1.0, -1.0)
    return naive + poly_blep(phase, inc) - poly_blep(jnp.mod(phase + 0.5, 1.0), inc)


def saw_naive(sample_index, freq, sample_rate):
    """Aliasing saw for A/B comparison (oscillator.rs:169-172)."""
    phase, _ = _phase(sample_index, freq, sample_rate)
    return 2.0 * phase - 1.0


def square_naive(sample_index, freq, sample_rate):
    """Aliasing square (oscillator.rs:164-167)."""
    phase, _ = _phase(sample_index, freq, sample_rate)
    return jnp.where(phase < 0.5, 1.0, -1.0)


def triangle_naive(sample_index, freq, sample_rate):
    """Aliasing /\\ triangle (oscillator.rs:174-179)."""
    phase, _ = _phase(sample_index, freq, sample_rate)
    return jnp.where(phase < 0.5, 4.0 * phase - 1.0, 3.0 - 4.0 * phase)


def triangle_additive(sample_index, freq, sample_rate, max_harmonics: int):
    """The reference's band-limited "triangle": an additive odd-harmonic sum.

    ``sum over odd i of  (1/i^2) * taper(i) * sin(2pi * f*i * t)`` with a
    quadratic Gibbs taper over the top 25% of the band and harmonics capped
    at Nyquist (oscillator.rs:106-131).  All harmonics share the positive
    sine phase (no alternating sign), faithfully matching the reference.

    Realization: ``sin(i*theta)`` via the Chebyshev-style recurrence
    ``sin((i+2)t) = 2cos(2t) sin(it) - sin((i-2)t)`` — one FMA pass per odd
    harmonic over the whole ``[V, B]`` block, no per-harmonic transcendentals.

    ``max_harmonics`` is the static unroll bound; it must be >= nyquist /
    min-possible-frequency for exactness at the lowest pitches.

    The ``fori_loop`` carries three ``[V, B]`` arrays through device
    memory on every harmonic.
    """
    theta = sample_index * freq * (TWO_PI / sample_rate)
    nyquist = sample_rate / 2.0
    sin1 = jnp.sin(theta)
    cos2x2 = 2.0 * jnp.cos(2.0 * theta)
    # reference loop bound: i <= floor(nyquist / f) and f*i <= nyquist
    max_i = jnp.floor(nyquist / jnp.maximum(freq, 1e-6))

    def body(k, carry):
        prev, curr, acc = carry  # curr = sin(i*theta) for i = 2k+1
        i = 2.0 * k + 1.0
        hfreq = freq * i
        ratio = hfreq / nyquist
        t = (ratio - 0.75) * 4.0
        taper = jnp.where(ratio > 0.75, 1.0 - t * t, 1.0)
        gain = taper / (i * i)
        active = (i <= max_i) & (hfreq <= nyquist)
        acc = acc + jnp.where(active, gain * curr, 0.0)
        nxt = cos2x2 * curr - prev
        return curr, nxt, acc

    n_terms = (max_harmonics + 1) // 2
    _, _, out = jax.lax.fori_loop(
        0,
        n_terms,
        lambda k, c: body(jnp.asarray(k, jnp.float32), c),
        (-sin1, sin1, jnp.zeros_like(sin1)),
    )
    return out
