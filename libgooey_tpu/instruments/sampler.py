"""SamplerRack: 16 sample pads × 32 voices with an embedded step sequencer.

Behavioral reference: src/instruments/sampler.rs (356 LoC).

* slots hold PCM (1-2 ch, any sample rate); voices play them once at
  ``buffer_sr / engine_sr`` increment with linear interpolation
  (sampler.rs:62-79, 118);
* fixed 32-frame edge fade click-guard (rs:127-135); oldest-age stealing
  (rs:196-206);
* embedded sequencer whose per-step *note* selects the slot (rs:228-237);
  transport-quantized pattern start via schedule_start/activate_start_if_due
  (rs:252-272).

Device layout: slot PCM lives in one device arena ``[A, 2]``; a voice's audio
is a pure function of samples-since-start (gathered stereo frames with the
edge fade), so the whole 32-voice pool renders as one batched gather.  The
host mirrors voice allocation (it knows every voice's end sample exactly).
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import jax.numpy as jnp
import numpy as np

from libgooey_tpu.engine.sequencer import Sequencer

SLOTS = 16
VOICES = 32
EDGE_FADE = 32.0
MAX_STARTS_PER_BLOCK = 16


class SamplerState(NamedTuple):
    """Device state: arena + per-voice latches ([VOICES] each)."""

    arena: jnp.ndarray        # [A, 2] slot PCM, stereo (mono duplicated)
    start_sample: jnp.ndarray  # [V] i32 global sample of voice start
    base: jnp.ndarray          # [V] i32 arena offset of the slot's first frame
    frames: jnp.ndarray        # [V] f32 slot length in frames
    increment: jnp.ndarray     # [V] f32 buffer_sr / engine_sr
    velocity: jnp.ndarray      # [V]


class StartEvents(NamedTuple):
    voice: jnp.ndarray      # [K] lane (-1 unused)
    offset: jnp.ndarray     # [K]
    base: jnp.ndarray       # [K]
    frames: jnp.ndarray     # [K]
    increment: jnp.ndarray  # [K]
    velocity: jnp.ndarray   # [K]

    @staticmethod
    def empty() -> "StartEvents":
        K = MAX_STARTS_PER_BLOCK
        return StartEvents(
            voice=jnp.full((K,), -1, jnp.int32), offset=jnp.zeros((K,), jnp.int32),
            base=jnp.zeros((K,), jnp.int32), frames=jnp.ones((K,), jnp.float32),
            increment=jnp.ones((K,), jnp.float32), velocity=jnp.zeros((K,), jnp.float32),
        )


def init_state(arena_frames: int = 1 << 20) -> SamplerState:
    return SamplerState(
        arena=jnp.zeros((arena_frames, 2), jnp.float32),
        start_sample=jnp.full((VOICES,), -(2**30), jnp.int32),
        base=jnp.zeros((VOICES,), jnp.int32),
        frames=jnp.ones((VOICES,), jnp.float32),
        increment=jnp.ones((VOICES,), jnp.float32),
        velocity=jnp.zeros((VOICES,), jnp.float32),
    )


def render_block(
    state: SamplerState,
    events: StartEvents,
    block_start,
    *,
    sample_rate: float,
    block_size: int,
):
    """Render one block → ``(new_state, out[2, B])``."""
    B = block_size
    n_local = jnp.arange(B, dtype=jnp.int32)
    block_start = jnp.asarray(block_start, jnp.int32)

    st = state
    start, base, frames, inc, vel = (
        st.start_sample, st.base, st.frames, st.increment, st.velocity
    )
    for k in range(MAX_STARTS_PER_BLOCK):
        v = events.voice[k]
        valid = v >= 0
        tgt = jnp.maximum(v, 0)

        def put(arr, new):
            return arr.at[tgt].set(jnp.where(valid, new, arr[tgt]))

        start = put(start, block_start + events.offset[k])
        base = put(base, events.base[k])
        frames = put(frames, events.frames[k])
        inc = put(inc, events.increment[k])
        vel = put(vel, events.velocity[k])

    n_global = block_start + n_local
    age = (n_global[None, :] - start[:, None]).astype(jnp.float32)   # [V,B]
    pos = age * inc[:, None]
    end = frames[:, None]
    active = (age >= 0.0) & (pos < end)

    # linear-interp stereo read (sampler.rs frame()) with position clamp
    posc = jnp.clip(pos, 0.0, end - 1.0)
    i0 = jnp.floor(posc).astype(jnp.int32)
    i1 = jnp.minimum(i0 + 1, (end - 1.0).astype(jnp.int32))
    frac = (posc - jnp.floor(posc))[..., None]
    f0 = st.arena[base[:, None] + i0]     # [V,B,2]
    f1 = st.arena[base[:, None] + i1]
    frame = f0 + (f1 - f0) * frac

    # 32-frame edge fade click-guard (rs:127-135)
    gain = jnp.minimum(
        jnp.minimum(posc / EDGE_FADE, jnp.maximum((end - posc) / EDGE_FADE, 0.0)),
        1.0,
    ) * vel[:, None]
    contrib = jnp.where(active[..., None], frame * gain[..., None], 0.0)
    out = jnp.sum(contrib, axis=0).T                                  # [2,B]

    new_state = st._replace(
        start_sample=start, base=base, frames=frames, increment=inc, velocity=vel
    )
    return new_state, out


class SamplerRackHost:
    """Host control: slot storage layout, voice stealing, embedded sequencer."""

    def __init__(self, sample_rate: float, bpm: float, name: str = "rack",
                 arena_frames: int = 1 << 20):
        self.sr = sample_rate
        self.name = name
        self.arena_frames = arena_frames
        self.arena = np.zeros((arena_frames, 2), np.float32)
        self.slot_meta: List[Optional[Tuple[int, int, float]]] = [None] * SLOTS
        self._next_free = 0
        self.arena_dirty = True
        self.voice_end = np.zeros(VOICES, np.int64)
        self.voice_age = np.zeros(VOICES, np.int64)
        self._age = 0
        self.sequencer = Sequencer(bpm, sample_rate, SLOTS, name)
        self.pattern_running = False
        self.pending_start_beat: Optional[float] = None
        self._starts: List[Tuple[int, int, float]] = []  # (slot, offset, vel)

    # --- slots -----------------------------------------------------------------

    def set_buffer(self, slot: int, samples: np.ndarray, sample_rate: float) -> bool:
        """Load PCM into a slot.  ``samples``: [frames] mono or [frames, 2]."""
        if not (0 <= slot < SLOTS):
            return False
        pcm = np.asarray(samples, np.float32)
        if pcm.ndim == 1:
            pcm = np.stack([pcm, pcm], axis=-1)
        frames = pcm.shape[0]
        if self._next_free + frames > self.arena_frames:
            raise RuntimeError("sampler arena full")
        base = self._next_free
        self.arena[base : base + frames] = pcm[:, :2]
        self._next_free += frames
        self.slot_meta[slot] = (base, frames, float(sample_rate))
        self.arena_dirty = True
        return True

    def clear_slot(self, slot: int) -> bool:
        if not (0 <= slot < SLOTS):
            return False
        self.slot_meta[slot] = None
        return True

    # --- triggering ---------------------------------------------------------------

    def trigger(self, slot: int, velocity: float, offset: int = 0) -> bool:
        if not (0 <= slot < SLOTS) or self.slot_meta[slot] is None:
            return False
        self._starts.append((slot, offset, float(np.clip(velocity, 0.0, 1.0))))
        return True

    def set_step(self, step: int, enabled: bool, slot: int, velocity: float) -> bool:
        if step >= SLOTS or slot >= SLOTS:
            return False
        self.sequencer.set_step_with_settings(step, enabled, velocity, note=slot)
        return True

    def schedule_start(self, beat: float) -> bool:
        if not np.isfinite(beat) or beat < 0:
            return False
        self.pattern_running = False
        self.sequencer.stop()
        self.pending_start_beat = float(beat)
        return True

    def activate_start_if_due(self, transport_beat: float):
        if self.pending_start_beat is None:
            return
        if transport_beat + 1e-8 < self.pending_start_beat:
            return
        target = self.pending_start_beat
        self.pending_start_beat = None
        self.sequencer.set_beat_position(target)
        self.sequencer.start()
        self.pattern_running = True

    def stop_pattern(self):
        self.pending_start_beat = None
        self.pattern_running = False
        self.sequencer.stop()
        self.voice_end[:] = 0  # stop_all

    def _allocate(self, now: int) -> int:
        free = np.nonzero(self.voice_end <= now)[0]
        idx = int(free[0]) if len(free) else int(np.argmin(self.voice_age))
        self._age += 1
        self.voice_age[idx] = self._age
        return idx

    def collect_events(self, block_start: int, block_size: int,
                       device: bool = True) -> StartEvents:
        if self.pattern_running:
            for trig in self.sequencer.tick_block(block_size):
                slot = trig.note if trig.note is not None else 0
                self.trigger(slot, trig.velocity, trig.offset)

        K = MAX_STARTS_PER_BLOCK
        voice = np.full(K, -1, np.int32)
        offset = np.zeros(K, np.int32)
        base = np.zeros(K, np.int32)
        frames = np.ones(K, np.float32)
        inc = np.ones(K, np.float32)
        vel = np.zeros(K, np.float32)
        for k, (slot, off, velocity) in enumerate(self._starts[:K]):
            meta = self.slot_meta[slot]
            if meta is None:
                continue
            b, fr, ssr = meta
            now = block_start + off
            v = self._allocate(now)
            voice[k] = v
            offset[k] = off
            base[k] = b
            frames[k] = fr
            inc[k] = ssr / self.sr
            vel[k] = velocity
            self.voice_end[v] = now + int(fr / (ssr / self.sr)) + 1
        self._starts.clear()
        if not device:
            return StartEvents(voice=voice, offset=offset, base=base,
                               frames=frames, increment=inc, velocity=vel)
        return StartEvents(
            voice=jnp.asarray(voice), offset=jnp.asarray(offset),
            base=jnp.asarray(base), frames=jnp.asarray(frames),
            increment=jnp.asarray(inc), velocity=jnp.asarray(vel),
        )
