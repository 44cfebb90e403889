"""Granulator: Arbhar-inspired frozen-scan granular instrument.

Behavioral reference: src/instruments/granulator.rs (1,154 LoC).

* pool of 64 grains + 16-slot release pool for soft-stolen grains (~4 ms
  fade, granulator.rs:13-25);
* spawn scheduler at `density` grains/s with zero-mean timing jitter
  (rs:508-539); per grain: source pos = scan*len ± spray (cubic-interp
  read), direction probability, speed = pitch_ratio * buf_sr/sr (exp map
  0.25-4x), raised-sine window shaped by texture, random amp (rs:541-610);
  edge-safe duration clamping (rs:584-600);
* 1/sqrt(active) gain compensation smoothed 10 ms (rs:652-660);
* drive = fixed-4x Waveshaper with mix as the knob (rs:26-32, 730-739);
* cloud trigger with duration 50-8000 ms; deterministic XorShift32 + set_seed.

Host/device split: *all* randomness happens at grain-spawn (control rate), so the
host schedules spawns/steals exactly (same XorShift32, same draw order) and
ships them as per-block events; each grain's audio is then a pure function
of samples-since-spawn — windowed cubic gathers from the device buffer,
fully vectorized over the 80 grain lanes.  The 1/sqrt(N) compensation uses
the device-side per-sample active count through a one-pole scan.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional

import jax.numpy as jnp
import numpy as np

from libgooey_tpu.core.rng import XorShift32
from libgooey_tpu.core.smoother import SmootherBank, smoothing_coeff
from libgooey_tpu.ops import scan as gscan
from libgooey_tpu.ops.oversample import OversamplerState, process as ovs_process

MAX_GRAINS = 64
RELEASE_POOL = 16
STEAL_RELEASE_MS = 4.0
DRIVE_INTERNAL = 4.0
MIN_GRAIN_MS, MAX_GRAIN_MS = 5.0, 3000.0
MAX_SPRAY_SECS = 10.0
MIN_CLOUD_MS, MAX_CLOUD_MS = 50.0, 8000.0
MAX_DENSITY = 80.0
MIN_PITCH, MAX_PITCH = 0.25, 4.0
MAX_SPAWNS_PER_BLOCK = 16

PARAM_NAMES = (
    "scan_position", "grain_length", "spray", "pitch", "density", "texture",
    "direction", "cloud_duration", "volume", "random_timing", "random_amp",
    "drive",
)
NUM_PARAMS = len(PARAM_NAMES)
PARAM_INDEX = {n: i for i, n in enumerate(PARAM_NAMES)}


def grain_length_ms(v):
    v = np.clip(v, 0.0, 1.0)
    return MIN_GRAIN_MS + v * v * (MAX_GRAIN_MS - MIN_GRAIN_MS)


def spray_seconds(v):
    v = np.clip(v, 0.0, 1.0)
    return v**3 * MAX_SPRAY_SECS


def pitch_ratio(v):
    v = np.clip(v, 0.0, 1.0)
    return MIN_PITCH * (MAX_PITCH / MIN_PITCH) ** v


def density_gps(v):
    return float(np.clip(v, 0.0, 1.0) * MAX_DENSITY)


def cloud_duration_ms(v):
    v = np.clip(v, 0.0, 1.0)
    return MIN_CLOUD_MS + v * (MAX_CLOUD_MS - MIN_CLOUD_MS)


def window_shape(texture):
    """Texture 0-1 → window power 0.5-4 (granulator.rs window_shape map)."""
    v = float(np.clip(texture, 0.0, 1.0))
    return 0.5 + v * 3.5


@dataclass(frozen=True)
class GranulatorConfig:
    scan_position: float = 0.5
    grain_length: float = 0.16
    spray: float = 0.12
    pitch: float = 0.5
    density: float = 0.35
    texture: float = 0.25
    direction: float = 0.0
    cloud_duration: float = 0.35
    volume: float = 0.8
    random_timing: float = 0.0
    random_amp: float = 0.0
    drive: float = 0.0

    def as_array(self) -> np.ndarray:
        return np.clip(
            np.array([getattr(self, n) for n in PARAM_NAMES], np.float32), 0.0, 1.0
        )


PRESETS = {"default": GranulatorConfig}

TOTAL = MAX_GRAINS + RELEASE_POOL


class GrainState(NamedTuple):
    """Device grain lanes: [TOTAL] each (main pool then release pool)."""

    params: SmootherBank        # [NUM_PARAMS] (single instance)
    spawn_sample: jnp.ndarray   # [TOTAL] i32
    duration: jnp.ndarray       # [TOTAL] samples
    src_pos: jnp.ndarray        # [TOTAL] start position (buffer samples)
    step: jnp.ndarray           # [TOTAL] speed*direction per engine sample
    shape: jnp.ndarray          # [TOTAL] window power
    vel: jnp.ndarray            # [TOTAL] velocity*amp_factor
    rel_start: jnp.ndarray      # [TOTAL] i32 release fade start (main: -1)
    rel_total: jnp.ndarray      # [TOTAL] fade length in samples (0 = none)
    gain_comp: jnp.ndarray      # scalar smoothed 1/sqrt(N)
    buffer: jnp.ndarray         # [L] mono source
    buffer_sr: jnp.ndarray      # scalar
    ovs: OversamplerState       # drive waveshaper 4x oversampler


class SpawnEvents(NamedTuple):
    """Per-block grain lifecycle events (host-computed, rs:541-610)."""

    slot: jnp.ndarray        # [K] lane index (-1 = unused); release-pool
    offset: jnp.ndarray      # [K] sample offset in block
    duration: jnp.ndarray    # [K]
    src_pos: jnp.ndarray     # [K]
    step: jnp.ndarray        # [K]
    shape: jnp.ndarray       # [K]
    vel: jnp.ndarray         # [K]
    rel_total: jnp.ndarray   # [K] (>0 for steals moved into the release pool)
    copy_from: jnp.ndarray   # [K] main lane to copy when stealing (-1 = spawn)

    @staticmethod
    def empty() -> "SpawnEvents":
        K = MAX_SPAWNS_PER_BLOCK
        z = lambda dt, fill=0: jnp.full((K,), fill, dt)
        return SpawnEvents(
            slot=z(jnp.int32, -1), offset=z(jnp.int32), duration=z(jnp.float32, 1),
            src_pos=z(jnp.float32), step=z(jnp.float32), shape=z(jnp.float32, 2),
            vel=z(jnp.float32), rel_total=z(jnp.float32), copy_from=z(jnp.int32, -1),
        )


def init_state(buffer: np.ndarray, buffer_sr: float,
               config: Optional[GranulatorConfig] = None) -> GrainState:
    cfg = (config or GranulatorConfig()).as_array()
    z = lambda fill=0.0: jnp.full((TOTAL,), fill, jnp.float32)
    return GrainState(
        params=SmootherBank.init(cfg),
        ovs=OversamplerState.init(()),
        spawn_sample=jnp.full((TOTAL,), -(2**30), jnp.int32),
        duration=z(1.0),
        src_pos=z(),
        step=z(1.0),
        shape=z(2.0),
        vel=z(),
        rel_start=jnp.full((TOTAL,), -1, jnp.int32),
        rel_total=z(),
        gain_comp=jnp.ones((), jnp.float32),
        buffer=jnp.asarray(buffer, jnp.float32),
        buffer_sr=jnp.asarray(buffer_sr, jnp.float32),
    )


def render_block(
    state: GrainState,
    events: SpawnEvents,
    block_start,
    *,
    sample_rate: float,
    block_size: int,
    smooth_coeff: float,
    overrides=None,
):
    """Render one block → ``(new_state, out[B])`` (mono instrument)."""
    B = block_size
    n_local = jnp.arange(B, dtype=jnp.int32)
    block_start = jnp.asarray(block_start, jnp.int32)

    # --- apply lifecycle events: steals (copies) first, then spawns ----------
    def apply_events(st: GrainState) -> GrainState:
        spawn, dur, src, stp, shp, vel, rstart, rtotal = (
            st.spawn_sample, st.duration, st.src_pos, st.step, st.shape, st.vel,
            st.rel_start, st.rel_total,
        )
        for k in range(MAX_SPAWNS_PER_BLOCK):
            slot = events.slot[k]
            valid = slot >= 0
            tgt = jnp.maximum(slot, 0)
            is_copy = events.copy_from[k] >= 0
            src_lane = jnp.maximum(events.copy_from[k], 0)

            def put(arr, new_val):
                cur = arr[tgt]
                copied = arr[src_lane]
                val = jnp.where(is_copy, copied, new_val)
                return arr.at[tgt].set(jnp.where(valid, val, cur))

            spawn = put(spawn, block_start + events.offset[k])
            dur = put(dur, events.duration[k])
            src = put(src, events.src_pos[k])
            stp = put(stp, events.step[k])
            shp = put(shp, events.shape[k])
            vel = put(vel, events.vel[k])
            # steals start their fade at the event offset; fresh spawns don't
            rstart = rstart.at[tgt].set(
                jnp.where(
                    valid,
                    jnp.where(is_copy, block_start + events.offset[k], -1),
                    rstart[tgt],
                )
            )
            rtotal = rtotal.at[tgt].set(
                jnp.where(valid, jnp.where(is_copy, events.rel_total[k], 0.0), rtotal[tgt])
            )
        return st._replace(
            spawn_sample=spawn, duration=dur, src_pos=src, step=stp, shape=shp,
            vel=vel, rel_start=rstart, rel_total=rtotal,
        )

    # NOTE: event offsets are handled at sample resolution below via masks;
    # grains start contributing only from their spawn offset because
    # age < 0 before it.
    st = apply_events(state)

    n_global = block_start + n_local                       # [B]
    age = (n_global[None, :] - st.spawn_sample[:, None]).astype(jnp.float32)
    in_life = (age >= 0.0) & (age < st.duration[:, None])

    # release fade (soft-stolen grains): gain ramps 1→0 over rel_total
    rel_age = (n_global[None, :] - st.rel_start[:, None]).astype(jnp.float32)
    has_rel = (st.rel_start >= 0)[:, None]
    rel_gain = jnp.where(
        has_rel & (st.rel_total[:, None] > 0),
        jnp.clip(1.0 - rel_age / jnp.maximum(st.rel_total[:, None], 1.0), 0.0, 1.0),
        1.0,
    )
    active = in_life & (rel_gain > 0.0)

    # window + cubic buffer read
    phase = jnp.clip(age / jnp.maximum(st.duration[:, None], 1.0), 0.0, 1.0)
    window = jnp.power(
        jnp.maximum(jnp.sin(np.pi * phase), 0.0), st.shape[:, None]
    )
    L = st.buffer.shape[0]
    pos = st.src_pos[:, None] + st.step[:, None] * age
    pos = jnp.clip(pos, 0.0, L - 1.0)
    i1 = jnp.floor(pos).astype(jnp.int32)
    frac = pos - jnp.floor(pos)
    p0 = st.buffer[jnp.clip(i1 - 1, 0, L - 1)]
    p1 = st.buffer[i1]
    p2 = st.buffer[jnp.clip(i1 + 1, 0, L - 1)]
    p3 = st.buffer[jnp.clip(i1 + 2, 0, L - 1)]
    a0 = -0.5 * p0 + 1.5 * p1 - 1.5 * p2 + 0.5 * p3
    a1 = p0 - 2.5 * p1 + 2.0 * p2 - 0.5 * p3
    a2 = -0.5 * p0 + 0.5 * p2
    sample = ((a0 * frac + a1) * frac + a2) * frac + p1

    contrib = jnp.where(active, sample * window * rel_gain * st.vel[:, None], 0.0)
    raw = jnp.sum(contrib, axis=0)                        # [B]

    # --- 1/sqrt(N) gain compensation, 10 ms one-pole (rs:652-660) ------------
    count = jnp.sum(active, axis=0).astype(jnp.float32)
    comp_target = jnp.where(count > 0, 1.0 / jnp.sqrt(jnp.maximum(count, 1.0)), 1.0)
    comp_coeff = smoothing_coeff(sample_rate, 10.0)
    comp = gscan.onepole(comp_coeff, comp_target, state.gain_comp)
    raw = raw * comp

    # --- drive (fixed 4x waveshaper, mix = drive knob) + volume ----------------
    powers = jnp.power(np.float32(1.0 - smooth_coeff),
                       jnp.arange(1, B + 1, dtype=jnp.float32))

    def ptraj(name):
        if overrides and name in overrides:
            return overrides[name]
        idx = PARAM_INDEX[name]
        tgt = state.params.target[idx]
        d = (state.params.current[idx] - tgt) * powers
        return tgt + jnp.where(jnp.abs(d) < 1e-4, 0.0, d)

    mix = ptraj("drive")
    comp_ws = np.float32(np.tanh(0.5) / np.tanh(0.5 * DRIVE_INTERNAL))
    new_ovs, shaped = ovs_process(
        state.ovs, lambda v: jnp.tanh(v * DRIVE_INTERNAL) * comp_ws, raw, 4
    )
    driven = jnp.where(mix <= 1e-4, raw, raw * (1.0 - mix) + shaped * mix)
    out = driven * ptraj("volume")

    q = np.float32(1.0 - smooth_coeff) ** np.float32(B)
    delta = state.params.current - state.params.target
    dec = delta * q
    new_params = SmootherBank(
        current=state.params.target + jnp.where(jnp.abs(dec) < 1e-4, 0.0, dec),
        target=state.params.target,
    )
    new_state = st._replace(params=new_params, gain_comp=comp[-1], ovs=new_ovs)
    return new_state, out


class GranulatorHost:
    """Host-side spawn scheduler: exact reference control logic (rs:508-676).

    Mirrors the grain pool allocation, soft-steal policy, XorShift32 draw
    order, and cloud timing; emits SpawnEvents per block.
    """

    def __init__(self, sample_rate: float, buffer: np.ndarray, buffer_sr: float,
                 config: Optional[GranulatorConfig] = None, seed: int = 0x12345678):
        self.sr = sample_rate
        self.buffer_len = len(buffer)
        self.buffer_sr = buffer_sr
        self.cfg = dict(zip(PARAM_NAMES, (config or GranulatorConfig()).as_array()))
        self.rng = XorShift32(seed)
        self.cloud_active = False
        self.cloud_end = 0.0
        self.next_grain_time = 0.0
        self.velocity = 1.0
        # host mirror of grain lifetimes: (end_sample) per lane
        self.main_end = np.zeros(MAX_GRAINS, np.int64)
        self.main_spawn = np.full(MAX_GRAINS, -(2**60), np.int64)
        self.main_dur = np.zeros(MAX_GRAINS, np.float64)
        self.rel_end = np.zeros(RELEASE_POOL, np.int64)

    def set_seed(self, seed: int):
        self.rng = XorShift32(seed)

    def set_param(self, name: str, value: float):
        self.cfg[name] = float(np.clip(value, 0.0, 1.0))

    def trigger(self, time_s: float, velocity: float = 1.0):
        self.velocity = float(np.clip(velocity, 0.0, 1.0))
        self.cloud_active = True
        self.cloud_end = time_s + cloud_duration_ms(self.cfg["cloud_duration"]) * 0.001
        self.next_grain_time = time_s

    def active_grain_count(self, now: int) -> int:
        return int((self.main_end > now).sum() + (self.rel_end > now).sum())

    def collect_events(self, block_start: int, block_size: int,
                       device: bool = True) -> SpawnEvents:
        """``device=False`` keeps the event arrays host-side (numpy) for
        span planners that stack K blocks before one upload."""
        ev = {
            "slot": np.full(MAX_SPAWNS_PER_BLOCK, -1, np.int32),
            "offset": np.zeros(MAX_SPAWNS_PER_BLOCK, np.int32),
            "duration": np.ones(MAX_SPAWNS_PER_BLOCK, np.float32),
            "src_pos": np.zeros(MAX_SPAWNS_PER_BLOCK, np.float32),
            "step": np.ones(MAX_SPAWNS_PER_BLOCK, np.float32),
            "shape": np.full(MAX_SPAWNS_PER_BLOCK, 2.0, np.float32),
            "vel": np.zeros(MAX_SPAWNS_PER_BLOCK, np.float32),
            "rel_total": np.zeros(MAX_SPAWNS_PER_BLOCK, np.float32),
            "copy_from": np.full(MAX_SPAWNS_PER_BLOCK, -1, np.int32),
        }
        k = 0
        if self.cloud_active:
            density = density_gps(self.cfg["density"])
            if density > 0:
                interval = 1.0 / density
                jitter_amt = float(np.clip(self.cfg["random_timing"], 0.0, 1.0))
                for n in range(block_size):
                    t = (block_start + n) / self.sr
                    if t > self.cloud_end:
                        self.cloud_active = False
                        break
                    guard = 0
                    while (self.cloud_active and t + 1e-12 >= self.next_grain_time
                           and guard < 8 and k < MAX_SPAWNS_PER_BLOCK - 1):
                        k = self._spawn(ev, k, block_start + n, n)
                        self.next_grain_time += interval
                        if jitter_amt > 0.0:
                            j = (self.rng.next_f32() * 2.0 - 1.0) * interval * jitter_amt
                            self.next_grain_time = max(self.next_grain_time + j, t)
                        if self.next_grain_time > self.cloud_end:
                            self.cloud_active = False
                        guard += 1
        if not device:
            return SpawnEvents(**ev)
        return SpawnEvents(**{key: jnp.asarray(v) for key, v in ev.items()})

    def _spawn(self, ev, k, now: int, offset: int) -> int:
        amp_jitter = self.rng.next_f32()  # pre-rolled (rs:548-550)

        free = np.nonzero(self.main_end <= now)[0]
        if len(free) == 0:
            # soft-steal: shortest remaining main grain → release pool
            remaining = self.main_end - now
            victim = int(np.argmin(remaining))
            rel_free = np.nonzero(self.rel_end <= now)[0]
            if len(rel_free) == 0:
                return k  # drop this spawn
            rel_slot = int(rel_free[0])
            release = max(STEAL_RELEASE_MS * 0.001 * self.sr, 1.0)
            release = min(release, max(float(self.main_end[victim] - now), 1.0))
            ev["slot"][k] = MAX_GRAINS + rel_slot
            ev["offset"][k] = offset
            ev["rel_total"][k] = release
            ev["copy_from"][k] = victim
            self.rel_end[rel_slot] = now + int(release) + 1
            self.main_end[victim] = now  # freed
            k += 1
            if k >= MAX_SPAWNS_PER_BLOCK:
                return k
            free = np.array([victim])
        slot = int(free[0])

        last = float(self.buffer_len - 1)
        scan = float(np.clip(self.cfg["scan_position"], 0, 1)) * last
        spray = spray_seconds(self.cfg["spray"]) * self.buffer_sr
        spray_off = (self.rng.next_f32() * 2.0 - 1.0) * spray
        requested = float(np.clip(scan + spray_off, 0.0, last))
        direction = -1.0 if self.rng.next_f32() < self.cfg["direction"] else 1.0
        speed = pitch_ratio(self.cfg["pitch"]) * (self.buffer_sr / self.sr)
        dur = max(grain_length_ms(self.cfg["grain_length"]) * 0.001 * self.sr, 1.0)
        shape = window_shape(self.cfg["texture"])
        travel = dur * speed
        if travel >= last:
            dur = max(last / speed, 1.0)
            src = last if direction < 0 else 0.0
        elif direction < 0:
            src = float(np.clip(requested, travel, last))
        else:
            src = float(np.clip(requested, 0.0, last - travel))
        amp_factor = 1.0 - float(np.clip(self.cfg["random_amp"], 0, 1)) * amp_jitter

        ev["slot"][k] = slot
        ev["offset"][k] = offset
        ev["duration"][k] = dur
        ev["src_pos"][k] = src
        ev["step"][k] = speed * direction
        ev["shape"][k] = shape
        ev["vel"][k] = self.velocity * amp_factor
        self.main_spawn[slot] = now
        self.main_dur[slot] = dur
        self.main_end[slot] = now + int(dur)
        return k + 1
