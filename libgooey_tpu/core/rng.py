"""Counter-based deterministic noise for massively parallel voices.

The reference uses three RNG styles (all deterministic and resettable):

* oscillator Noise waveform — a *hash of the sample index*
  (src/gen/oscillator.rs:187-196): already counter-based, embarrassingly
  parallel.
* pink-noise white source — sequential xorshift64* reseeded on every trigger
  (src/gen/pink_noise.rs:67-79).
* granulator — sequential XorShift32 stepped at grain-spawn control events
  (src/instruments/granulator.rs:833-867), i.e. host-rate, not audio-rate.

A batched device design cannot afford sequential audio-rate RNG state, so the
device-side white sources here are **counter-based**: a stateless integer mix
of ``(seed, counter)`` where the counter is samples-since-trigger.  This
preserves every behavioral contract the reference tests assert (determinism,
``reset()`` restores the exact sequence, white spectrum, bounded output,
float32-exact mantissas via the top-24-bit trick) while being exactly
parallel.  The *bit sequences* differ from the Rust implementation — noise is
statistically, not bitwise, identical to the reference.

The sequential XorShift32/xorshift64* generators are also provided (host-side
numpy) for control-rate uses such as grain spawning.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

#: Default seed, same spirit as the reference's fixed pink-noise seed
#: (src/gen/pink_noise.rs RNG_SEED).
DEFAULT_SEED = 0x9ABCDEF0


def mix32(x):
    """A murmur3-style 32-bit finalizer: bijective avalanche mix."""
    x = jnp.asarray(x, jnp.uint32)
    x = x ^ (x >> 16)
    x = x * jnp.uint32(0x7FEB352D)
    x = x ^ (x >> 15)
    x = x * jnp.uint32(0x846CA68B)
    x = x ^ (x >> 16)
    return x


def hash2(counter, seed):
    """Mix a counter with a seed into decorrelated 32 bits."""
    c = jnp.asarray(counter, jnp.uint32)
    s = jnp.asarray(seed, jnp.uint32)
    # golden-ratio sequence offset decorrelates consecutive seeds
    return mix32(c ^ mix32(s * jnp.uint32(0x9E3779B9) + jnp.uint32(0x85EBCA6B)))


def white(counter, seed=DEFAULT_SEED):
    """White noise in [-1, 1] from an integer counter.

    Uses the top 24 bits so every value is exactly representable in float32 —
    the same trick as the reference (src/gen/pink_noise.rs:76-78).
    """
    bits = hash2(counter, seed) >> jnp.uint32(8)
    norm = bits.astype(jnp.float32) / np.float32((1 << 24) - 1)
    return norm * 2.0 - 1.0


def white_from_sample_index(sample_index, seed=DEFAULT_SEED):
    """Noise-waveform oscillator source: hash of the (integer) sample index.

    Mirrors src/gen/oscillator.rs:187-196 (`noise_wave_time_based`), which
    hashes `current_sample_index as u64`.  Negative indices (not yet
    triggered) still produce defined values; callers gate by envelope.
    """
    return white(jnp.asarray(sample_index, jnp.int32).astype(jnp.uint32), seed)


# --- host-side sequential generators (control rate) -------------------------


class XorShift32:
    """Sequential xorshift32 as used by the granulator (granulator.rs:833-867)."""

    def __init__(self, seed: int = 0x12345678):
        self.state = np.uint32(seed if seed != 0 else 1)

    def next_u32(self) -> int:
        x = np.uint32(self.state)
        with np.errstate(over="ignore"):
            x ^= np.uint32((int(x) << 13) & 0xFFFFFFFF)
            x ^= x >> np.uint32(17)
            x ^= np.uint32((int(x) << 5) & 0xFFFFFFFF)
        self.state = x
        return int(x)

    def next_f32(self) -> float:
        """Uniform in [0, 1) from the top 24 bits."""
        return (self.next_u32() >> 8) / float(1 << 24)


class XorShift64Star:
    """Sequential xorshift64* (reference pink-noise source, pink_noise.rs:67-79)."""

    MULT = 0x2545F4914F6CDD1D

    def __init__(self, seed: int = 0x123456789ABCDEF0):
        self.state = seed & 0xFFFFFFFFFFFFFFFF

    def next_u64(self) -> int:
        x = self.state
        x ^= x >> 12
        x = (x ^ (x << 25)) & 0xFFFFFFFFFFFFFFFF
        x ^= x >> 27
        self.state = x
        return (x * self.MULT) & 0xFFFFFFFFFFFFFFFF

    def next_white(self) -> float:
        """White sample in [-1, 1] via the top-24-bit float trick."""
        normalized = (self.next_u64() >> 40) / float((1 << 24) - 1)
        return normalized * 2.0 - 1.0
