"""Per-sample scalar oracle for the HiHat (v1) voice.

Sequential float32 mirror of src/instruments/hihat.rs:498-672 semantics as
realized by libgooey_tpu.instruments.hihat.render_block (dual noise sources
sharing one hash stream, latched envelope shapes, envelope-swept one-pole
output low-pass).  The blocked bank must agree with this to <=1e-4
(the -80 dBFS bar every other family is pinned to).
"""

from __future__ import annotations

import numpy as np

from kick_oracle import _Smoother, _hash_white, denorm

F = np.float32
TWO_PI = F(2.0 * np.pi)


def adsr_amp(elapsed, attack, decay, sustain, a_curve=1.0, d_curve=1.0):
    """core.envelope.amplitude mirror WITHOUT the 1 ms minimums — the bank
    constructs raw ``ADSR`` tuples here (not via the clamping ``adsr()``
    helper), so the oracle must not clamp either."""
    if elapsed < 0:
        return F(0.0)
    if elapsed < attack:
        p = elapsed / attack
        return F(max(p, 0.0) ** min(max(a_curve, 0.1), 10.0))
    if elapsed < attack + decay:
        p = (elapsed - attack) / decay
        curved = max(p, 0.0) ** min(max(d_curve, 0.1), 10.0)
        return F(1.0 - (1.0 - sustain) * curved)
    return F(sustain)

FREQ_RANGE = (4000.0, 16000.0)
DECAY_RANGE = (0.005, 0.4)
AMP_DECAY_RANGE = (0.0, 4.0)
CURVE_RANGE = (0.1, 10.0)

VELOCITY_TO_DECAY = F(0.4)   # hihat.rs:407
VELOCITY_TO_PITCH = F(0.3)   # hihat.rs:408
FILTER_ENV_AMOUNT = F(0.15)  # hihat.rs:401

PARAM_NAMES = ("frequency", "filter", "decay", "volume", "amp_decay",
               "amp_decay_curve")


class HiHatOracle:
    def __init__(self, config: dict, sample_rate=44100.0, coeff=None,
                 is_open=False):
        from libgooey_tpu.core.smoother import smoothing_coeff

        self.sr = float(sample_rate)
        c = coeff if coeff is not None else float(
            np.asarray(smoothing_coeff(sample_rate)))
        self.p = {n: _Smoother(min(max(config.get(n, 0.5), 0.0), 1.0), c)
                  for n in PARAM_NAMES}
        self.is_open = bool(is_open)
        self.trig_sample = -(2**30)
        self.vel = F(1.0)
        self.boost = F(1.0)
        self.d = F(0.08)
        self.ad = F(0.4)
        self.ac = F(1.0)
        self.filt_y = F(0.0)
        self.n = 0
        self._pending = None

    def set_param(self, name, value):
        self.p[name].set_target(value)

    def trigger(self, velocity):
        self._pending = F(min(max(velocity, 0.0), 1.0))

    def tick(self):
        # trigger latch reads the PRE-tick smoother state (VoiceBlock.vat)
        if self._pending is not None:
            v = self._pending
            vel2 = F(v * v)
            scale = F(1.0 - VELOCITY_TO_DECAY * vel2)
            self.vel = v
            self.d = F(denorm(self.p["decay"].cur, *DECAY_RANGE) * scale)
            self.ad = F(denorm(self.p["amp_decay"].cur, *AMP_DECAY_RANGE)
                        * scale)
            ac = denorm(self.p["amp_decay_curve"].cur, *CURVE_RANGE)
            self.ac = F(1.0) if abs(ac - 1.0) < 0.01 else ac
            self.boost = F(1.0 + VELOCITY_TO_PITCH * vel2)
            self.trig_sample = self.n
            self._pending = None

        for s in self.p.values():
            s.tick()

        # mirror the bank's f32 index: idx_f = f32(n - trig_sample) rounds
        # the huge pre-trigger sentinel distances exactly like
        # VoiceBlock.elapsed (matters for the open hat, whose sustain-wash
        # envelopes are nonzero pre-trigger and gate hashed noise)
        idx_f = F(self.n - self.trig_sample)
        idx = int(np.floor(idx_f))
        elapsed = F(idx_f * F(1.0 / self.sr))
        d, ad, ac = self.d, self.ad, self.ac

        # envelopes — latched shapes (hihat.rs:575-672); raw ADSR fields
        # (no 1 ms min clamp; the bank constructs ADSR directly)
        if self.is_open:
            noise_env = adsr_amp(elapsed, 0.001, F(d * F(0.2)), F(0.4))
            amp_env = adsr_amp(elapsed, 0.001, F(ad * F(0.3)), F(0.3),
                               1.0, ac)
        else:
            noise_env = adsr_amp(elapsed, 0.001, d, F(0.0))
            amp_env = adsr_amp(elapsed, 0.001, ad, F(0.0), 1.0, ac)
        bright_env = adsr_amp(elapsed, 0.001, F(d * F(0.2)), F(0.0))
        filt_env = adsr_amp(elapsed, 0.001, F(d * F(0.5)), F(0.0))

        # both oscillators hash the same (elapsed) sample index
        w = F(_hash_white(idx))
        filt = self.p["filter"].cur
        combined = F(w * noise_env + F(w * bright_env) * F(filt * F(0.5)))
        shaped = F(F(combined * amp_env) * F(1.0 + filt * F(0.8)))

        base_cutoff = denorm(self.p["frequency"].cur, *FREQ_RANGE)
        velocity_cutoff_boost = F(F(self.boost - 1.0) * filt_env * base_cutoff)
        envelope_boost = F(filt_env * FILTER_ENV_AMOUNT * base_cutoff)
        cutoff = F(min(base_cutoff + filt * F(6000.0) + envelope_boost
                       + velocity_cutoff_boost, self.sr * 0.45))
        g = F(min(max(1.0 - np.exp(F(-TWO_PI * cutoff / F(self.sr))), 0.0),
                  1.0))
        self.filt_y = F(self.filt_y + g * (shaped - self.filt_y))
        y = self.filt_y if abs(self.filt_y) >= 1e-15 else F(0.0)

        out = F(y * self.p["volume"].cur * F(np.sqrt(self.vel)))
        self.n += 1
        return float(out)
