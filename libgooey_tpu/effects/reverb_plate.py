"""Dattorro plate reverb: figure-eight tank with modulated allpasses.

Behavioral reference: src/effects/plate_reverb.rs (765 LoC) — Jon Dattorro's
"Effect Design Part 1" plate: predelay (0-200 ms) → input bandwidth one-pole
(0.9995) → 4 input-diffusion allpasses → two cross-coupled branches, each

    modulated allpass (gain 0.70, LFO 0.50/0.71 Hz, ±16-sample excursion)
    → delay → damping one-pole → * decay → allpass(dd2) → delay → cross-feed

with a 7-tap output matrix per channel across both branches, mid/side width,
and a size knob (0.25x-2x) rescaling all tank delays through fractional
reads.  The tank is shared: stereo input is mono-summed (plate_reverb.rs:
551-563).

Block mapping.  Every tank delay-line lag (d1/d2/ap2) exceeds ~666 samples
even at minimum size, so for block sizes up to that bound the whole tank is
FEED-FORWARD given per-block gathers: reads at sample n only touch
pre-block history.  The six tank lines are rows of ONE [6, LT] matrix, so
all six reads are two gathers (lerp endpoints), the six writes one aligned
dynamic-update-slice, and the 14 output taps two more gathers.  The only
sub-block recurrences — the input-diffusion chain (lags ≥ ~158) and the two
LFO-modulated allpasses (lags ≥ ~213) — run chunked over right-aligned work
histories.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from libgooey_tpu.core.smoother import SmootherBank, smoothing_coeff
from libgooey_tpu.ops import ringbuf, scan as gscan

DATTORRO_SR = 29_761.0
INPUT_AP_DELAYS = (142.0, 107.0, 379.0, 277.0)
INPUT_AP_GAINS = (0.750, 0.750, 0.625, 0.625)
TANK_AP1_A, TANK_DELAY1_A, TANK_AP2_A, TANK_DELAY2_A = 672.0, 4453.0, 1800.0, 3720.0
TANK_AP1_B, TANK_DELAY1_B, TANK_AP2_B, TANK_DELAY2_B = 908.0, 4217.0, 2656.0, 3163.0
DECAY_DIFFUSION_1 = 0.70
EXCURSION = 16.0
LFO_RATE_A, LFO_RATE_B = 0.50, 0.71
INPUT_BANDWIDTH = 0.9995
MAX_DECAY = 0.95
MAX_PREDELAY_MS = 200.0
OUTPUT_SCALE = 0.6
MAX_SIZE_SCALE = 2.0

#: tank matrix rows
T_D1A, T_D1B, T_AP2A, T_AP2B, T_D2A, T_D2B = range(6)
_TANK_BASES = (TANK_DELAY1_A, TANK_DELAY1_B, TANK_AP2_A, TANK_AP2_B,
               TANK_DELAY2_A, TANK_DELAY2_B)
_LINE_ROW = {"d1a": T_D1A, "d1b": T_D1B, "ap2a": T_AP2A, "ap2b": T_AP2B,
             "d2a": T_D2A, "d2b": T_D2B}

# left taps: (line, offset at 29761 Hz, sign); lines: d1a,d1b,ap2a,ap2b,d2a,d2b
LEFT_TAPS = (
    ("d1b", 266.0, +1.0), ("d1b", 2974.0, +1.0), ("ap2b", 1913.0, -1.0),
    ("d2b", 1996.0, +1.0), ("d1a", 1990.0, -1.0), ("ap2a", 187.0, -1.0),
    ("d2a", 1066.0, -1.0),
)
RIGHT_TAPS = (
    ("d1a", 353.0, +1.0), ("d1a", 3627.0, +1.0), ("ap2a", 1228.0, -1.0),
    ("d2a", 2673.0, +1.0), ("d1b", 2111.0, -1.0), ("ap2b", 335.0, -1.0),
    ("d2b", 121.0, -1.0),
)

PARAMS = ("decay", "mix", "damping", "predelay", "width", "size")
P_DECAY, P_MIX, P_DAMPING, P_PREDELAY, P_WIDTH, P_SIZE = range(6)


def size_to_scale(size):
    """0 → 0.25x, 0.5 → 1x, 1 → 2x (plate_reverb.rs:83-90)."""
    return jnp.where(
        size <= 0.5,
        jnp.power(4.0, 2.0 * size - 1.0),
        jnp.power(2.0, 2.0 * size - 1.0),
    )


def _srs(sample_rate: float) -> float:
    return sample_rate / DATTORRO_SR


def tank_len(sample_rate: float) -> int:
    """[6, LT] tank-matrix row length: covers the longest lag at 2x size,
    rounded to a multiple of 512 so block writes are one aligned
    dynamic-update-slice."""
    need = int(np.ceil(max(_TANK_BASES) * MAX_SIZE_SCALE * _srs(sample_rate))) + 8
    return ((need + 511) // 512) * 512


def in_hist_len(sample_rate: float) -> int:
    return int(np.ceil(max(INPUT_AP_DELAYS) * _srs(sample_rate))) + 4


def mod_hist_len(sample_rate: float) -> int:
    srs = _srs(sample_rate)
    return int(np.ceil(
        max(TANK_AP1_A, TANK_AP1_B) * MAX_SIZE_SCALE * srs + EXCURSION * srs
    )) + 4


class PlateState(NamedTuple):
    predelay: ringbuf.Ring
    in_hist: jnp.ndarray   # [4, DIN] input-AP histories, right-aligned
    mod_hist: jnp.ndarray  # [2, DMOD] modulated-AP histories, right-aligned
    tank: jnp.ndarray      # [6, LT] rows d1a,d1b,ap2a,ap2b,d2a,d2b
    pos: jnp.ndarray       # scalar int32: samples written to the tank
    bandwidth: jnp.ndarray
    damp_a: jnp.ndarray
    damp_b: jnp.ndarray
    fb_a: jnp.ndarray
    fb_b: jnp.ndarray
    lfo_phase: jnp.ndarray  # [2]
    smooth: SmootherBank    # [6]


def init_state(sample_rate: float, decay: float = 0.5, mix: float = 0.3,
               damping: float = 0.5, predelay: float = 0.0, width: float = 1.0,
               size: float = 0.5) -> PlateState:
    return PlateState(
        # rounded up to a multiple of 128 (extra capacity is inert: taps
        # never exceed MAX_PREDELAY_MS)
        predelay=ringbuf.Ring.init(
            (int(np.ceil(MAX_PREDELAY_MS * 0.001 * sample_rate)) + 8 + 127)
            // 128 * 128
        ),
        in_hist=jnp.zeros((4, in_hist_len(sample_rate)), jnp.float32),
        mod_hist=jnp.zeros((2, mod_hist_len(sample_rate)), jnp.float32),
        tank=jnp.zeros((6, tank_len(sample_rate)), jnp.float32),
        pos=jnp.zeros((), jnp.int32),
        bandwidth=jnp.zeros((), jnp.float32),
        damp_a=jnp.zeros((), jnp.float32),
        damp_b=jnp.zeros((), jnp.float32),
        fb_a=jnp.zeros((), jnp.float32),
        fb_b=jnp.zeros((), jnp.float32),
        lfo_phase=jnp.zeros(2, jnp.float32),
        smooth=SmootherBank.init(
            np.clip(
                np.array([decay, mix, damping, predelay, width, size], np.float32),
                0.0, 1.0,
            )
        ),
    )


def chunk_size(sample_rate: float, block_size: int) -> int:
    """Chunk must not exceed the shortest *chunk-processed* lag at minimum
    size (0.25x): the input-diffusion and modulated allpasses.  All other
    tank lags exceed :func:`min_tank_lag` and are read at block level."""
    srs = _srs(sample_rate)
    min_lag = min(
        min(INPUT_AP_DELAYS) * srs,
        TANK_AP1_A * 0.25 * srs - EXCURSION * srs,
        TANK_AP1_B * 0.25 * srs - EXCURSION * srs,
    )
    c = block_size
    while c > min_lag:
        c //= 2
    return max(c, 1)


def min_tank_lag(sample_rate: float) -> int:
    """Shortest possible non-chunked tank lag (ap2_a at 0.25x size)."""
    return int(min(_TANK_BASES) * 0.25 * _srs(sample_rate))


def _tank_read(tank, pos, offs):
    """Pre-write fractional read of all 6 tank rows at once.

    offs: [6, B] float offsets (samples ago); clamped [1, LT-2].  TWO
    gathers (lerp endpoints) instead of twelve.
    """
    LT = tank.shape[-1]
    B = offs.shape[-1]
    offs = jnp.clip(offs, 1.0, LT - 2.0)
    whole = jnp.floor(offs)
    frac = offs - whole
    n = jnp.arange(B, dtype=jnp.int32)[None, :]
    base = pos + n - whole.astype(jnp.int32)
    # ONE gather for both lerp endpoints ([6, 2B] indices), not two
    idx = jnp.concatenate([jnp.mod(base, LT), jnp.mod(base - 1, LT)], axis=-1)
    ab = jnp.take_along_axis(tank, idx, axis=-1)
    a, b = ab[:, :B], ab[:, B:]
    return a + frac * (b - a)


def _tank_taps(tank, pos_after, offs, rows, n_written):
    """Post-write fractional taps: offs [14, B] with static source rows."""
    LT = tank.shape[-1]
    B = offs.shape[-1]
    offs = jnp.clip(offs, 0.0, LT - 2.0)
    whole = jnp.floor(offs)
    frac = offs - whole
    n = jnp.arange(B, dtype=jnp.int32)[None, :]
    base = pos_after - n_written + n - whole.astype(jnp.int32)
    rsel = np.asarray(rows, np.int32)[:, None] * LT
    # ONE flat gather for all 14 taps x both lerp endpoints, not two
    # 2-D advanced-index gathers
    idx = jnp.concatenate(
        [rsel + jnp.mod(base, LT), rsel + jnp.mod(base - 1, LT)], axis=-1
    )
    ab = jnp.take(tank.reshape(-1), idx)
    a, b = ab[:, :B], ab[:, B:]
    return a + frac * (b - a)


def _tank_write(tank, pos, vals):
    """Append vals [6, B]; one aligned dynamic-update-slice (LT % B == 0
    and pos advances in fixed B steps), else a modulo scatter."""
    LT = tank.shape[-1]
    B = vals.shape[-1]
    if LT % B == 0:
        return jax.lax.dynamic_update_slice(
            tank, vals, (jnp.int32(0), jnp.mod(pos, LT))
        )
    idx = jnp.mod(pos + jnp.arange(B, dtype=jnp.int32), LT)
    return tank.at[:, idx].set(vals)


def process_block(
    state: PlateState,
    x,             # [2, B]
    targets,       # [6]: decay, mix, damping, predelay, width, size (0-1)
    *,
    sample_rate: float,
):
    """One block of the plate → ``(new_state, out[2, B])``."""
    B = x.shape[-1]
    C = chunk_size(sample_rate, B)
    srs = _srs(sample_rate)
    exc = EXCURSION * srs
    x = jnp.where(jnp.isfinite(x), x, 0.0)
    mono_in = 0.5 * (x[0] + x[1])

    coeff = smoothing_coeff(sample_rate)
    bank = state.smooth.with_targets(jnp.asarray(targets, jnp.float32))
    powers = jnp.power(np.float32(1.0 - coeff), jnp.arange(1, B + 1, dtype=jnp.float32))

    def traj(idx):
        tgt = bank.target[idx]
        delta = bank.current[idx] - tgt
        d = delta * powers
        return tgt + jnp.where(jnp.abs(d) < 1e-4, 0.0, d)

    raw = [traj(i) for i in range(len(PARAMS))]
    decay_t = raw[P_DECAY] * MAX_DECAY
    mix_t = raw[P_MIX]
    damping_t = raw[P_DAMPING] * 0.95
    predelay_t = raw[P_PREDELAY] * (MAX_PREDELAY_MS * 0.001 * sample_rate)
    width_t = raw[P_WIDTH]
    size_t = size_to_scale(raw[P_SIZE])
    dd2_t = jnp.clip(decay_t + 0.15, 0.25, 0.50)

    # free-running LFOs (advance-then-use)
    n_idx = jnp.arange(1, B + 1, dtype=jnp.float32)
    ph_a = jnp.mod(state.lfo_phase[0] + n_idx * (LFO_RATE_A / sample_rate), 1.0)
    ph_b = jnp.mod(state.lfo_phase[1] + n_idx * (LFO_RATE_B / sample_rate), 1.0)
    lfo_a_t = jnp.sin(2.0 * np.pi * ph_a)
    lfo_b_t = jnp.sin(2.0 * np.pi * ph_b)

    s = state
    DIN = s.in_hist.shape[-1]
    DMOD = s.mod_hist.shape[-1]

    # The tank is feed-forward at block level: every tank lag is >= B
    # (see module docstring), so reads gather pre-block history only.
    assert B <= min_tank_lag(sample_rate), (
        "block exceeds the shortest block-level tank lag; lower block_size"
    )

    # --- predelay (post-write fractional tap), block level ------------------
    pre_ring = ringbuf.write_block(s.predelay, mono_in)
    delayed_in = ringbuf.tap_frac(pre_ring, predelay_t, B)

    # --- block-level tank reads: ONE pair of gathers for all 6 lines --------
    tank_offs = jnp.stack([
        TANK_DELAY1_A * srs * size_t, TANK_DELAY1_B * srs * size_t,
        TANK_AP2_A * srs * size_t, TANK_AP2_B * srs * size_t,
        TANK_DELAY2_A * srs * size_t, TANK_DELAY2_B * srs * size_t,
    ])
    reads = _tank_read(s.tank, s.pos, tank_offs)
    d1a_read, d1b_read = reads[T_D1A], reads[T_D1B]
    ap2a_read, ap2b_read = reads[T_AP2A], reads[T_AP2B]
    d2a_read, d2b_read = reads[T_D2A], reads[T_D2B]

    fb_a_t = jnp.concatenate([s.fb_a[None], (d2a_read * decay_t)[:-1]])
    fb_b_t = jnp.concatenate([s.fb_b[None], (d2b_read * decay_t)[:-1]])

    # modulated-allpass per-sample offsets (clamped like ring read_frac)
    moda_off = jnp.clip(TANK_AP1_A * srs * size_t + lfo_a_t * exc,
                        1.0, DMOD - 2.0)
    modb_off = jnp.clip(TANK_AP1_B * srs * size_t + lfo_b_t * exc,
                        1.0, DMOD - 2.0)

    # --- bandwidth + damping scans, chunked input/mod APs -------------------
    bw_full = gscan.linrec1(
        jnp.full((B,), 1.0 - INPUT_BANDWIDTH, jnp.float32),
        INPUT_BANDWIDTH * delayed_in,
        s.bandwidth,
    )
    bw0 = bw_full[-1]
    da = gscan.linrec1(damping_t, d1a_read * (1.0 - damping_t), s.damp_a)
    db = gscan.linrec1(damping_t, d1b_read * (1.0 - damping_t), s.damp_b)
    da0, db0 = da[-1], db[-1]

    W_in = jnp.concatenate(
        [s.in_hist, jnp.zeros((4, B), jnp.float32)], axis=-1
    )
    W_mod = jnp.concatenate(
        [s.mod_hist, jnp.zeros((2, B), jnp.float32)], axis=-1
    )
    mod_off = jnp.stack([moda_off, modb_off])  # [2, B]
    mod_whole = jnp.floor(mod_off)
    mod_frac = mod_off - mod_whole
    a1_parts, b1_parts = [], []
    for k in range(B // C):
        sl = slice(k * C, (k + 1) * C)
        sck = k * C
        bw = bw_full[sl]

        # input diffusion: static-lag reads + affine chain
        alpha, beta = 1.0, 0.0
        sdir, sadd, sdel = [], [], []
        for i, (d, g) in enumerate(zip(INPUT_AP_DELAYS, INPUT_AP_GAINS)):
            o = max(d * srs, 1.0)
            w = int(np.floor(o))
            f = np.float32(o - w)
            col = DIN + sck - w
            av = W_in[i, col:col + C]
            bv = W_in[i, col - 1:col - 1 + C]
            dv = av + f * (bv - av)
            sdir.append(alpha)
            sadd.append(beta)
            sdel.append(dv)
            beta = g * beta + (1.0 - g * g) * dv
            alpha = alpha * g
        sig = alpha * bw + beta
        for i, g in enumerate(INPUT_AP_GAINS):
            v_i = (sdir[i] * bw + sadd[i]) - g * sdel[i]
            W_in = jax.lax.dynamic_update_slice(
                W_in, v_i[None, :], (jnp.int32(i), jnp.int32(DIN + sck))
            )

        in_a = sig + fb_b_t[sl]
        in_b = sig + fb_a_t[sl]

        # modulated APs: per-sample gathers into the work rows
        n_c = jnp.arange(sck, sck + C, dtype=jnp.int32)[None, :]
        col_a = DMOD + n_c - mod_whole[:, sl].astype(jnp.int32)
        av = jnp.take_along_axis(W_mod, col_a, axis=-1)
        bv = jnp.take_along_axis(W_mod, col_a - 1, axis=-1)
        delayed = av + mod_frac[:, sl] * (bv - av)
        ins = jnp.stack([in_a, in_b])
        v = ins - DECAY_DIFFUSION_1 * delayed
        outs = DECAY_DIFFUSION_1 * v + delayed
        a1_parts.append(outs[0])
        b1_parts.append(outs[1])
        W_mod = jax.lax.dynamic_update_slice(
            W_mod, v, (jnp.int32(0), jnp.int32(DMOD + sck))
        )

    a1 = jnp.concatenate(a1_parts)
    b1 = jnp.concatenate(b1_parts)
    new_in_hist = W_in[:, B:B + DIN]
    new_mod_hist = W_mod[:, B:B + DMOD]

    # --- tank math (block-level, elementwise) -------------------------------
    v2a = da * decay_t - dd2_t * ap2a_read
    a2 = dd2_t * v2a + ap2a_read
    v2b = db * decay_t - dd2_t * ap2b_read
    b2 = dd2_t * v2b + ap2b_read

    # --- one aligned write for all 6 lines, then the 14 output taps ---------
    tank = _tank_write(
        s.tank, s.pos, jnp.stack([a1, b1, v2a, v2b, a2, b2])
    )
    # keep pos reduced mod LT: a free-running int32 would wrap after ~13.5 h
    # at 44.1 kHz, and LT is not a power of two, so the wrap would misindex
    # the tank; every consumer already reduces mod LT so this is free
    pos_after = jnp.mod(s.pos + B, s.tank.shape[-1])

    tap_rows = [_LINE_ROW[ln] for ln, _, _ in LEFT_TAPS + RIGHT_TAPS]
    tap_offs = jnp.stack(
        [off * srs * size_t for _, off, _ in LEFT_TAPS + RIGHT_TAPS]
    )
    tap_signs = np.asarray(
        [sg for _, _, sg in LEFT_TAPS + RIGHT_TAPS], np.float32
    )[:, None]
    tapped = _tank_taps(tank, pos_after, tap_offs, tap_rows, B) * tap_signs
    yl = OUTPUT_SCALE * jnp.sum(tapped[:7], axis=0)
    yr = OUTPUT_SCALE * jnp.sum(tapped[7:], axis=0)
    mid = 0.5 * (yl + yr)
    side = 0.5 * (yl - yr) * width_t
    wet_l = mid + side
    wet_r = mid - side

    out = jnp.stack(
        [x[0] * (1.0 - mix_t) + wet_l * mix_t, x[1] * (1.0 - mix_t) + wet_r * mix_t]
    )
    out = jnp.where(jnp.isfinite(out), out, x)

    new_state = s._replace(
        predelay=pre_ring,
        in_hist=new_in_hist,
        mod_hist=new_mod_hist,
        tank=tank,
        pos=pos_after,
        bandwidth=bw0,
        damp_a=da0,
        damp_b=db0,
        fb_a=d2a_read[-1] * decay_t[-1],
        fb_b=d2b_read[-1] * decay_t[-1],
        lfo_phase=jnp.stack([ph_a[-1], ph_b[-1]]),
        smooth=SmootherBank(
            current=jnp.stack([r[-1] for r in raw]),
            target=bank.target,
        ),
    )
    return new_state, out
