"""Pink noise: counter-based white source + Paul Kellet economy filter.

Behavioral reference: src/gen/pink_noise.rs — three parallel one-poles with
sample-rate-rescaled poles (``p^(44100/sr)``) and variance-preserving gains,
plus a direct white term; output gain 0.11.  The tests there assert a
−3 dB/oct slope consistent across 44.1/48/96 kHz and exact reset behavior —
both preserved here.

Differences from the reference: the white source is counter-based (see
core.rng) instead of sequential xorshift64*, so it parallelizes over
``[V, B]``; `reset()` corresponds to restarting the counter and zeroing the
filter states, which the trigger path does via the reset mask.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
import numpy as np

from libgooey_tpu.core import rng
from libgooey_tpu.ops import scan as gscan

REFERENCE_SAMPLE_RATE = 44_100.0
REFERENCE_POLES = np.array([0.99765, 0.96300, 0.57000], np.float32)
REFERENCE_GAINS = np.array([0.0990460, 0.2965164, 1.0526913], np.float32)
DIRECT_GAIN = 0.1848
OUTPUT_GAIN = 0.11


def coefficients(sample_rate: float):
    """Sample-rate-adjusted (poles, gains) — pink_noise.rs:26-46."""
    rate_ratio = REFERENCE_SAMPLE_RATE / max(sample_rate, 1.0)
    poles = REFERENCE_POLES**rate_ratio
    gains = REFERENCE_GAINS * np.sqrt(
        (1.0 - poles * poles) / (1.0 - REFERENCE_POLES * REFERENCE_POLES)
    )
    return poles.astype(np.float32), gains.astype(np.float32)


class PinkState(NamedTuple):
    """Per-voice filter state, shape ``[..., 3]``."""

    fstate: jnp.ndarray

    @staticmethod
    def init(shape=()) -> "PinkState":
        return PinkState(fstate=jnp.zeros(tuple(shape) + (3,), jnp.float32))


def pink_block(
    state: PinkState,
    counters,
    sample_rate: float,
    seed=rng.DEFAULT_SEED,
    reset=None,
):
    """Generate a block of pink noise.

    Args:
      state: carried filter state, ``[..., 3]`` matching counters' batch dims.
      counters: integer samples-since-trigger, ``[..., B]`` (drives the white
        source; restarts the sequence at triggers, mirroring `reset()`).
      reset: optional bool ``[..., B]`` mask zeroing filter state at trigger
        offsets (the reference resets pink noise state on kick trigger,
        kick.rs:1082-1085).

    Returns ``(new_state, pink[..., B])``.
    """
    poles, gains = coefficients(sample_rate)
    w = rng.white(jnp.asarray(counters, jnp.int32).astype(jnp.uint32), seed)

    outs = []
    new_states = []
    for i in range(3):
        a = jnp.full_like(w, poles[i])
        if reset is not None:
            a = jnp.where(reset, 0.0, a)
        y = gscan.linrec1(a, gains[i] * w, state.fstate[..., i])
        outs.append(y)
        new_states.append(y[..., -1])

    pink = (outs[0] + outs[1] + outs[2] + w * DIRECT_GAIN) * OUTPUT_GAIN
    return PinkState(fstate=jnp.stack(new_states, axis=-1)), pink
