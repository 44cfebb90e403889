"""Per-channel/per-track effect chain: the reorderable EFFECT_* rack.

Behavioral reference: src/mixer/effect_chain.rs (429 LoC) — a typed, ordered
list over the 9 reorderable effects with musically-useful defaults
(effect_chain.rs:57-108) and `set_param(PARAM_*, value)` dispatch
(rs:156-230).  Shared by loop channels AND mixer-graph tracks.

Here a chain is a host object holding ordered entries (effect id, staged
targets) plus a matching list of device states; processing folds the stereo
block through the entries (the order is trace-time static, so reordering
recompiles — a rare control action).
"""

from __future__ import annotations

from typing import List, Optional

import jax.numpy as jnp
import numpy as np

from libgooey_tpu.effects import (
    compressor as fx_compressor,
    delay as fx_delay,
    feedback_waveshaper as fx_fbws,
    lowpass as fx_lowpass,
    reverb_plate as fx_plate,
    reverb_spring as fx_spring,
    saturation as fx_saturation,
    tilt as fx_tilt,
    waveshaper as fx_ws,
)
from libgooey_tpu.ops import oversample as fx_oversample

# EFFECT_* ids (ffi.rs:1548-1579)
EFFECT_LOWPASS_FILTER = 0
EFFECT_DELAY = 1
EFFECT_SATURATION = 2
EFFECT_COMPRESSOR = 3
EFFECT_TILT_FILTER = 4
EFFECT_LIMITER = 5
EFFECT_REVERB = 6
EFFECT_WAVESHAPER = 7
EFFECT_FEEDBACK_WAVESHAPER = 8
EFFECT_PLATE_REVERB = 9
REORDERABLE_EFFECT_COUNT = 9


def _default_targets(effect_id: int, bpm: float):
    """from_id defaults (effect_chain.rs:57-108)."""
    if effect_id == EFFECT_LOWPASS_FILTER:
        return np.array([20000.0, 0.0], np.float32)
    if effect_id == EFFECT_DELAY:
        return np.array(
            [fx_delay.timing_to_seconds(fx_delay.TIMING_QUARTER, bpm), 0.3, 0.3, 8000.0],
            np.float32,
        )
    if effect_id == EFFECT_SATURATION:
        return np.array([0.3, 0.4, 0.5], np.float32)
    if effect_id == EFFECT_COMPRESSOR:
        return np.array([-12.0, 4.0, 5.0, 100.0, 0.5], np.float32)
    if effect_id == EFFECT_TILT_FILTER:
        return np.array([0.5, 0.0], np.float32)
    if effect_id == EFFECT_REVERB:
        return np.array([0.5, 0.3, 0.5], np.float32)
    if effect_id == EFFECT_PLATE_REVERB:
        return np.array([0.5, 0.3, 0.5, 0.0, 1.0, 0.5], np.float32)
    if effect_id == EFFECT_WAVESHAPER:
        return np.array([1.0, 0.0], np.float32)
    if effect_id == EFFECT_FEEDBACK_WAVESHAPER:
        return np.array([1.0, 0.0, 2000.0, 0.0], np.float32)
    return None


def _init_device_state(effect_id: int, sample_rate: float):
    if effect_id == EFFECT_LOWPASS_FILTER:
        return fx_lowpass.init_state(sample_rate, 20000.0, 0.0)
    if effect_id == EFFECT_DELAY:
        return fx_delay.init_state(sample_rate, 0.5, 0.3, 0.3, 8000.0)
    if effect_id == EFFECT_SATURATION:
        return fx_saturation.init_state(sample_rate, 0.3, 0.4, 0.5)
    if effect_id == EFFECT_COMPRESSOR:
        return fx_compressor.init_state(sample_rate, -12.0, 4.0, 5.0, 100.0, 0.5)
    if effect_id == EFFECT_TILT_FILTER:
        return fx_tilt.init_state(sample_rate)
    if effect_id == EFFECT_REVERB:
        return fx_spring.init_state(sample_rate, 0.5, 0.3, 0.5)
    if effect_id == EFFECT_PLATE_REVERB:
        return fx_plate.init_state(sample_rate, 0.5, 0.3, 0.5)
    if effect_id == EFFECT_WAVESHAPER:
        return fx_oversample.OversamplerState.init((2,))  # 4x nonlinearity
    if effect_id == EFFECT_FEEDBACK_WAVESHAPER:
        return fx_fbws.FBShaperState.init((2,))
    return None


class Entry:
    def __init__(self, effect_id: int, sample_rate: float, bpm: float):
        self.effect_id = effect_id
        self.targets = _default_targets(effect_id, bpm)
        self.pingpong = False
        self.timing = fx_delay.TIMING_QUARTER
        self.bpm = bpm

    def set_param(self, param: int, value: float):
        """PARAM_* dispatch (effect_chain.rs:156-230, ffi.rs:1582-1730)."""
        eid = self.effect_id
        if eid == EFFECT_DELAY:
            if param == 0:      # DELAY_PARAM_TIMING
                self.timing = int(value)
                self.targets[0] = fx_delay.timing_to_seconds(self.timing, self.bpm)
            elif param == 4:    # DELAY_PARAM_PINGPONG
                self.pingpong = value >= 0.5
            else:
                self.targets[param] = value
        else:
            self.targets[param] = value

    def get_param(self, param: int) -> float:
        if self.effect_id == EFFECT_DELAY:
            if param == 0:
                return float(self.timing)
            if param == 4:
                return 1.0 if self.pingpong else 0.0
        return float(self.targets[param])

    def set_bpm(self, bpm: float):
        self.bpm = bpm
        if self.effect_id == EFFECT_DELAY:
            self.targets[0] = fx_delay.timing_to_seconds(self.timing, bpm)


def process_entry(effect_id: int, state, x, targets, *, sample_rate: float,
                  pingpong: bool = False, sidechain=None):
    """Run one chain entry on a stereo block → (new_state, y).

    ``pingpong`` is the entry's static flag: ping-pong mode for the delay,
    zero-feedback fast path for the feedback waveshaper (see static_key).
    """
    if effect_id == EFFECT_LOWPASS_FILTER:
        return fx_lowpass.process_block(state, x, targets, sample_rate=sample_rate)
    if effect_id == EFFECT_DELAY:
        return fx_delay.process_block(state, x, targets, sample_rate=sample_rate,
                                      pingpong=pingpong)
    if effect_id == EFFECT_SATURATION:
        return fx_saturation.process_block(state, x, targets, sample_rate=sample_rate)
    if effect_id == EFFECT_COMPRESSOR:
        return fx_compressor.process_block(state, x, targets, sample_rate=sample_rate,
                                           sidechain=sidechain)
    if effect_id == EFFECT_TILT_FILTER:
        return fx_tilt.process_block(state, x, targets, sample_rate=sample_rate)
    if effect_id == EFFECT_REVERB:
        return fx_spring.process_block(state, x, targets, sample_rate=sample_rate)
    if effect_id == EFFECT_PLATE_REVERB:
        return fx_plate.process_block(state, x, targets, sample_rate=sample_rate)
    if effect_id == EFFECT_WAVESHAPER:
        from libgooey_tpu.effects import freeze as frz

        # waveshaper.rs:55-57 early return: the whole block is bypassed
        # (drive/mix are per-block scalars here), so the oversampler
        # history holds exactly (effects/freeze.py)
        held = (targets[1] <= 1e-4) | (targets[0] <= 1.0)
        wrap, box = fx_oversample.stateful(state, 4)
        y = fx_ws.process(x, targets[0], mix=targets[1], oversample=wrap)
        return frz.hold_where(held, state, box["state"]), y
    if effect_id == EFFECT_FEEDBACK_WAVESHAPER:
        new_state, y = fx_fbws.process_block(
            state, x, targets[0], targets[1],
            fx_fbws.filter_coeff(targets[2], sample_rate), targets[3],
            sample_rate, feedback_path=not pingpong,
        )
        return new_state, y
    raise KeyError(effect_id)


class EffectChain:
    """Host chain: ordered entries + device states, add/remove/move/clear."""

    def __init__(self, sample_rate: float, bpm: float = 120.0):
        self.sample_rate = sample_rate
        self.bpm = bpm
        self.entries: List[Entry] = []
        self.states: List = []

    def order(self):
        return tuple(e.effect_id for e in self.entries)

    def add(self, effect_id: int) -> bool:
        if _default_targets(effect_id, self.bpm) is None:
            return False
        self.entries.append(Entry(effect_id, self.sample_rate, self.bpm))
        self.states.append(_init_device_state(effect_id, self.sample_rate))
        return True

    def remove(self, index: int) -> bool:
        if not (0 <= index < len(self.entries)):
            return False
        self.entries.pop(index)
        self.states.pop(index)
        return True

    def move(self, src: int, dst: int) -> bool:
        n = len(self.entries)
        if not (0 <= src < n and 0 <= dst < n):
            return False
        self.entries.insert(dst, self.entries.pop(src))
        self.states.insert(dst, self.states.pop(src))
        return True

    def clear(self):
        self.entries.clear()
        self.states.clear()

    def reset(self):
        """Re-init all device states (reference reset clears DSP history)."""
        self.states = [
            _init_device_state(e.effect_id, self.sample_rate) for e in self.entries
        ]

    def set_bpm(self, bpm: float):
        self.bpm = bpm
        for e in self.entries:
            e.set_bpm(bpm)

    def set_param(self, index: int, param: int, value: float) -> bool:
        if not (0 <= index < len(self.entries)):
            return False
        self.entries[index].set_param(param, value)
        return True

    def get_param(self, index: int, param: int) -> float:
        return self.entries[index].get_param(param)

    def targets_list(self):
        return [jnp.asarray(e.targets) for e in self.entries]

    def static_key(self):
        """Trace-static (effect_id, flag) pairs; the flag is the delay's
        ping-pong mode, or the feedback waveshaper's zero-feedback fast
        path (every factory preset ships feedback 0 — the general
        per-sample loop only compiles in when the host sets feedback)."""
        def flag(e):
            if e.effect_id == EFFECT_DELAY:
                return e.pingpong
            if e.effect_id == EFFECT_FEEDBACK_WAVESHAPER:
                return float(e.targets[1]) == 0.0
            return False
        return tuple((e.effect_id, flag(e)) for e in self.entries)


def process_chain(states, x, targets_list, static_key, *, sample_rate: float):
    """Fold a stereo block through the chain (trace-static order)."""
    new_states = []
    for (effect_id, pingpong), st, tg in zip(static_key, states, targets_list):
        st, x = process_entry(
            effect_id, st, x, tg, sample_rate=sample_rate, pingpong=pingpong
        )
        new_states.append(st)
    return new_states, x
