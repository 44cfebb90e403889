"""Shared per-block trigger/latch machinery for batched instruments.

Every reference instrument follows the same Config/Params pattern
(SURVEY.md §2.5): smoothed normalized params, trigger-time snapshots,
per-sample time-based evaluation.  ``VoiceBlock`` packages the batched
realization used by all instrument banks:

* closed-form smoothed-parameter trajectories with the reference's exact
  settle-snap (one-pole, smoother.rs:120-137);
* the value a trigger reads = smoother state after ``offset`` ticks
  (triggers are processed before the instrument's own tick of that sample,
  ffi.rs:1152-1205);
* per-sample latched values via ``after``-masks; elapsed-time arrays from a
  carried last-trigger sample index.

Multiple triggers per voice per block: ``trig_offset`` may be ``[V, K]``
(offsets ascending per voice, ``block_size`` = none).  Each sample sees the
snapshot of the *most recent* trigger at or before it, exactly like the
reference's per-sample retrigger (a later trigger re-snapshots envelopes and
resets phases mid-block).  K is static — the host packs the per-block trigger
lists and only K > 1 blocks compile the wider variant.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
import numpy as np

from libgooey_tpu.core.smoother import SmootherBank

NEVER = np.int32(-(2**30))  # "never triggered" sentinel


class VoiceBlock:
    """Per-block context for a V-voice instrument bank."""

    def __init__(self, bank: SmootherBank, trig_offset, block_start,
                 block_size: int, smooth_coeff: float, param_index: dict,
                 overrides=None):
        self.bank = bank
        self.B = block_size
        self.q = np.float32(1.0 - smooth_coeff)
        self.param_index = param_index
        #: LFO-modulated parameter trajectories ``{name: [V, B]}`` — computed
        #: by the engine as one-pole scans toward per-sample targets
        #: (ffi.rs:1237-1250 applies LFO routes before the instrument tick).
        self.overrides = overrides or {}
        self.powers = jnp.power(self.q, jnp.arange(1, block_size + 1, dtype=jnp.float32))

        self.n_local = jnp.arange(block_size, dtype=jnp.int32)
        off = jnp.asarray(trig_offset, jnp.int32)
        #: legacy single-trigger mode: snapshots stay [V]-shaped so existing
        #: instrument math (and its compiled graphs) is untouched
        self.legacy = off.ndim == 1
        if self.legacy:
            off = off[:, None]
        self.trig_offset = off                                   # [V, K]
        self.K = off.shape[1]
        self.block_start = jnp.asarray(block_start, jnp.int32)
        self.trig_global = self.block_start + off                # [V, K]
        self.has_trig_k = off < block_size                       # [V, K]
        self.has_trig = jnp.any(self.has_trig_k, axis=1)         # [V]
        n = self.n_local[None, :]
        # per-slot masks [V, K, B]; `after`/`at_trig` collapse over K
        self.after_k = (n[:, None, :] >= off[:, :, None]) & self.has_trig_k[:, :, None]
        self.after = jnp.any(self.after_k, axis=1)               # [V, B]
        self.at_trig = jnp.any(
            (n[:, None, :] == off[:, :, None]) & self.has_trig_k[:, :, None], axis=1
        )                                                        # [V, B]

    def _as_vk(self, new):
        """Normalize a snapshot to ``[V, K]`` (a ``[V]`` value fills slot 0;
        only valid in legacy K=1 mode where that's the only slot)."""
        new = jnp.asarray(new)
        return new[:, None] if new.ndim == 1 else new

    def ptraj(self, name: str):
        """Smoothed per-sample trajectory of one param, ``[V, B]``."""
        if name in self.overrides:
            return self.overrides[name]
        idx = self.param_index[name]
        tgt = self.bank.target[:, idx, None]
        delta = (self.bank.current[:, idx] - self.bank.target[:, idx])[:, None]
        decayed = delta * self.powers
        return tgt + jnp.where(jnp.abs(decayed) < 1e-4, 0.0, decayed)

    def value_at_trigger(self, name: str):
        """Smoothed value as read by each trigger slot.

        Returns ``[V]`` in legacy single-trigger mode, ``[V, K]`` otherwise —
        matching the shape of the host-supplied trigger arrays so snapshot
        arithmetic composes without silent broadcasting.
        """
        idx = self.param_index[name]
        if name in self.overrides:
            traj = self.overrides[name]                              # [V, B]
            off = jnp.clip(self.trig_offset - 1, 0, self.B - 1)      # [V, K]
            at = jnp.take_along_axis(traj, off, axis=1)              # [V, K]
            out = jnp.where(
                self.trig_offset == 0, self.bank.current[:, idx, None], at
            )
        else:
            tgt = self.bank.target[:, idx, None]                     # [V, 1]
            delta = self.bank.current[:, idx, None] - tgt
            decayed = delta * jnp.power(
                self.q, jnp.clip(self.trig_offset, 0, self.B).astype(jnp.float32)
            )
            out = tgt + jnp.where(jnp.abs(decayed) < 1e-4, 0.0, decayed)
        return out[:, 0] if self.legacy else out

    def eff(self, new, old):
        """Per-sample latched value ([V,B]): each trigger's snapshot applies
        from its offset; the most recent trigger wins (slots ascending)."""
        new = self._as_vk(new)
        out = jnp.broadcast_to(old[:, None], self.after.shape)
        for k in range(self.K):
            out = jnp.where(self.after_k[:, k, :], new[:, k, None], out)
        return out

    def eff_vec(self, new, old):
        """Vector variant: new ``[V,K,D]``, old ``[V,D]`` → ``[V,B,D]``."""
        out = jnp.broadcast_to(old[:, None, :], self.after.shape + old.shape[-1:])
        for k in range(self.K):
            out = jnp.where(self.after_k[:, k, :, None], new[:, k, None, :], out)
        return out

    def latch(self, new, old):
        """End-of-block latched state ([V]): the LAST trigger's value."""
        new = self._as_vk(new)
        out = old
        for k in range(self.K):
            out = jnp.where(self.has_trig_k[:, k], new[:, k], out)
        return out

    def latch_vec(self, new, old):
        """Vector variant: new ``[V,K,D]``, old ``[V,D]`` → ``[V,D]``."""
        out = old
        for k in range(self.K):
            out = jnp.where(self.has_trig_k[:, k, None], new[:, k, :], out)
        return out

    def trig_eff(self, prev_trig_sample):
        """Per-sample global index of the governing trigger ([V,B])."""
        out = jnp.broadcast_to(prev_trig_sample[:, None], self.after.shape)
        for k in range(self.K):
            out = jnp.where(self.after_k[:, k, :], self.trig_global[:, k, None], out)
        return out

    def elapsed(self, prev_trig_sample, sample_rate: float):
        """(trig_eff, elapsed_i[V,B] int32, idx_f[V,B] f32, elapsed_s[V,B] s)."""
        trig_eff = self.trig_eff(prev_trig_sample)
        n_global = self.block_start + self.n_local
        elapsed_i = n_global[None, :] - trig_eff
        idx_f = elapsed_i.astype(jnp.float32)
        return trig_eff, elapsed_i, idx_f, idx_f * np.float32(1.0 / sample_rate)

    def advance_bank(self) -> SmootherBank:
        """Smoother state at the end of the block (closed form + settle)."""
        delta = self.bank.current - self.bank.target
        decayed = delta * self.q ** np.float32(self.B)
        new_current = self.bank.target + jnp.where(jnp.abs(decayed) < 1e-4, 0.0, decayed)
        for name, traj in self.overrides.items():
            idx = self.param_index[name]
            new_current = new_current.at[:, idx].set(traj[:, -1])
        return SmootherBank(current=new_current, target=self.bank.target)


def phase_mod_env(elapsed, active_mask):
    """DS-style PhaseModulator envelope (fm_snap.rs:102-169).

    1 ms rise ``p^0.3``, 5 ms fall ``1 - p^0.4``, zero outside [0, 6 ms];
    gated by ``active_mask`` (armed at trigger when amount > 0.001)."""
    rise = jnp.power(jnp.maximum(elapsed / 0.001, 0.0), 0.3)
    fall = 1.0 - jnp.power(jnp.maximum((elapsed - 0.001) / 0.005, 0.0), 0.4)
    env = jnp.where(elapsed < 0.001, rise, fall)
    return jnp.where((elapsed >= 0.0) & (elapsed <= 0.006) & active_mask, env, 0.0)


def fm_snap_block(phase0, elapsed, sample_rate, *, attack=0.001, decay=0.008,
                  carrier_freq=50.0, modulator_freq=500.0, modulation_index=2.0):
    """FM "snap" transient blip (fm_snap.rs:3-94) as a block function.

    The reference integrates instantaneous frequency one sample at a time;
    here the integral is a cumulative sum over the block (phase carried
    across blocks via ``phase0``).  ``elapsed`` [..., B] is seconds since
    trigger; negative or post-envelope samples are inactive (silent, and
    their frequency contribution is the plain carrier, matching the
    reference's frozen phase once is_active drops).

    Returns ``(phase_out, y)`` with ``y = sin(phase) * env``.
    """
    t = jnp.asarray(elapsed, jnp.float32)
    active = (t >= 0.0) & (t <= attack + decay)
    env = jnp.where(
        t < attack,
        jnp.maximum(t, 0.0) / attack,
        jnp.clip(jnp.exp(-(t - attack) / decay), 0.0, 1.0),
    )
    env = jnp.where(active, env, 0.0)
    mod = jnp.sin(2.0 * jnp.pi * modulator_freq * t)
    f_inst = carrier_freq + modulation_index * mod * env
    dphi = jnp.where(active, 2.0 * jnp.pi * f_inst / sample_rate, 0.0)
    phase = jnp.asarray(phase0, jnp.float32)[..., None] + jnp.cumsum(dphi, axis=-1)
    y = jnp.sin(phase) * env
    return jnp.mod(phase[..., -1], 2.0 * jnp.pi), y
