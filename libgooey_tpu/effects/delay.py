"""BPM-synced filter delay with ping-pong mode.

Behavioral reference: src/effects/delay.rs (668 LoC).

* timing: 9 musical divisions incl. triplets → seconds at the current BPM,
  capped at 5 s (delay.rs:27-100);
* fractional circular-buffer read with linear interpolation; the delayed
  signal passes a two-pole resonant low-pass (fixed res 0.3) that sits in
  both the wet output and the feedback path, so echoes darken;
* write = inject + feedback * filtered_tap; timing changes clear the buffer
  and snap the time smoother (delay.rs:333-340);
* ping-pong: the left buffer is fed dry input + the right tap, the right
  buffer only the left tap (delay.rs:460-491);
* smoothing: 50 ms (time), 30 ms (feedback/mix/cutoff).

Block mapping: the delay time is always ≥ one block at musical BPMs, so a
block's reads reference only previously written samples — the whole effect
is one gather + a linrec2 filter scan + elementwise write/scatter.  (The
shortest division, a sixteenth triplet, dips below 512 samples only above
~320 BPM; the host clamps BPM at 300 like typical hosts.)
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
import numpy as np

from libgooey_tpu.core.smoother import SmootherBank, smoothing_coeff
from libgooey_tpu.ops import ringbuf, scan as gscan
from libgooey_tpu.ops.filters import _shift1

MAX_DELAY_TIME = 5.0
FILTER_RESONANCE = 0.3

#: DELAY_TIMING_* constants (delay.rs:71-100): beats per division.
TIMING_BEATS = (4.0, 2.0, 1.0, 0.5, 0.25, 4.0 / 3.0, 2.0 / 3.0, 1.0 / 3.0, 1.0 / 6.0)
TIMING_WHOLE, TIMING_HALF, TIMING_QUARTER, TIMING_EIGHTH, TIMING_SIXTEENTH = range(5)
TIMING_HALF_TRIPLET, TIMING_QUARTER_TRIPLET, TIMING_EIGHTH_TRIPLET = 5, 6, 7
TIMING_SIXTEENTH_TRIPLET = 8


def timing_to_seconds(timing: int, bpm: float) -> float:
    return min(60.0 / bpm * TIMING_BEATS[timing], MAX_DELAY_TIME)


class DelayState(NamedTuple):
    """Stereo delay state (channel axis leading on per-channel fields)."""

    ring: ringbuf.Ring          # buf [2, L]
    filter_z: jnp.ndarray       # [2, 2] two-pole LP state (z1, z2)
    smooth: SmootherBank        # [2, 4]: time, feedback, mix, cutoff


PARAM_TIME, PARAM_FEEDBACK, PARAM_MIX, PARAM_CUTOFF = range(4)


def init_state(sample_rate: float, time_s: float = 0.5, feedback: float = 0.3,
               mix: float = 0.3, cutoff: float = 8000.0) -> DelayState:
    # rounded to a multiple of 512 so block writes are one aligned
    # dynamic-update-slice for any power-of-two block size up to 512
    # (the extra capacity is inert: reads never exceed MAX_DELAY_TIME)
    L = (int(sample_rate * MAX_DELAY_TIME) + 1 + 511) // 512 * 512
    init = np.array([
        [min(time_s, MAX_DELAY_TIME), np.clip(feedback, 0, 0.95),
         np.clip(mix, 0, 1), np.clip(cutoff, 20.0, 20000.0)],
    ] * 2, np.float32)
    return DelayState(
        ring=ringbuf.Ring.init(L, batch=(2,)),
        filter_z=jnp.zeros((2, 2), jnp.float32),
        smooth=SmootherBank.init(init),
    )


def smoothing_coeffs(sample_rate: float):
    """(time 50 ms, others 30 ms) one-pole coefficients (delay.rs:203-213)."""
    return (
        smoothing_coeff(sample_rate, 50.0),
        smoothing_coeff(sample_rate, 30.0),
    )


def process_block(
    state: DelayState,
    x,                       # [2, B]
    targets,                 # [4] staged targets: time_s, feedback, mix, cutoff
    *,
    sample_rate: float,
    pingpong: bool = False,
):
    """One block of the stereo delay → ``(new_state, out[2, B])``."""
    B = x.shape[-1]
    x = jnp.where(jnp.isfinite(x), x, 0.0)
    c_time, c_other = smoothing_coeffs(sample_rate)

    # per-sample smoothed params (closed form, separate time constants)
    bank = state.smooth.with_targets(
        jnp.broadcast_to(jnp.asarray(targets, jnp.float32), (2, 4))
    )
    pw_time = jnp.power(1.0 - c_time, jnp.arange(1, B + 1, dtype=jnp.float32))

    def traj(idx, powers):
        tgt = bank.target[:, idx, None]
        delta = (bank.current[:, idx] - bank.target[:, idx])[:, None]
        decayed = delta * powers
        return tgt + jnp.where(jnp.abs(decayed) < 1e-4, 0.0, decayed)

    time_traj = traj(PARAM_TIME, pw_time)          # [2, B] seconds

    # fractional delayed read (lag >= block: all data pre-block)
    delay_samples = time_traj * sample_rate
    delayed = ringbuf.read_frac(state.ring, delay_samples, min_offset=1.0)

    pw_other = jnp.power(1.0 - c_other, jnp.arange(1, B + 1, dtype=jnp.float32))
    fb_traj = traj(PARAM_FEEDBACK, pw_other)
    mix_traj = traj(PARAM_MIX, pw_other)
    cutoff_traj = traj(PARAM_CUTOFF, pw_other)

    # two-pole resonant LP on the delayed signal (delay.rs:370-384):
    #   z1' = z1 + g*(x + r*(z1 - z2) - z1);  z2' = z2 + g*(z1' - z2)
    g = 1.0 - jnp.exp(-2.0 * np.pi * cutoff_traj / sample_rate)
    r = FILTER_RESONANCE
    a11 = 1.0 - g + g * r
    a12 = -g * r
    b1 = g * delayed
    a21 = g * a11
    a22 = (1.0 - g) + g * a12
    b2 = g * b1
    z1, z2 = gscan.linrec2(
        a11, a12, a21, a22, b1, b2, (state.filter_z[:, 0], state.filter_z[:, 1])
    )
    filtered = z2

    # write phase: inject + feedback * tap
    if pingpong:
        tap_for = jnp.stack([filtered[1], filtered[0]], axis=0)  # partner taps
        inject = jnp.stack([x[0], jnp.zeros_like(x[1])], axis=0)
    else:
        tap_for = filtered
        inject = x
    write = inject + tap_for * fb_traj
    write = jnp.where(jnp.isfinite(write) & (jnp.abs(write) > 1e-15), write, 0.0)
    ring = ringbuf.write_block(state.ring, write)

    out = x * (1.0 - mix_traj) + filtered * mix_traj
    out = jnp.where(jnp.isfinite(out), out, x)

    new_state = DelayState(
        ring=ring,
        filter_z=jnp.stack([z1[:, -1], z2[:, -1]], axis=-1),
        smooth=SmootherBank(
            current=jnp.stack(
                [time_traj[:, -1], fb_traj[:, -1], mix_traj[:, -1], cutoff_traj[:, -1]],
                axis=-1,
            ),
            target=bank.target,
        ),
    )
    return new_state, out


def reset(state: DelayState) -> DelayState:
    """Clear buffer + filter (timing change / explicit reset, delay.rs:229-245)."""
    return DelayState(
        ring=ringbuf.Ring.init(state.ring.buf.shape[-1], batch=(2,)),
        filter_z=jnp.zeros_like(state.filter_z),
        smooth=state.smooth,
    )
