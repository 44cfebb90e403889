"""Per-sample scalar oracle for the TomDrum (v1) voice.

Sequential float32 mirror of src/instruments/tom.rs semantics as realized by
libgooey_tpu.instruments.tom.render_block: tonal sine + additive-triangle
punch at 3f, live pitch-envelope sweep, latched amp envelope with 0.5+0.5v
velocity decay scale.  The additive triangle replays the bank's exact
Chebyshev recurrence (ops.osc.triangle_additive) so the comparison is
pointwise.  The bank must agree to <=1e-4.
"""

from __future__ import annotations

import numpy as np

from hihat_oracle import adsr_amp
from kick_oracle import _Smoother, denorm

F = np.float32
TWO_PI = F(2.0 * np.pi)

FREQ_RANGE = (60.0, 300.0)
DECAY_RANGE = (0.05, 2.0)
AMP_DECAY_RANGE = (0.0, 4.0)
CURVE_RANGE = (0.1, 10.0)

PARAM_NAMES = ("frequency", "tonal", "punch", "decay", "pitch_drop",
               "volume", "amp_decay", "amp_decay_curve")


def triangle_additive(idx, freq, sr, max_harmonics):
    """f32 mirror of ops.osc.triangle_additive's Chebyshev recurrence."""
    theta = F(F(idx * freq) * F(TWO_PI / sr))
    nyquist = F(sr / 2.0)
    sin1 = F(np.sin(theta))
    cos2x2 = F(2.0 * np.cos(F(2.0 * theta)))
    max_i = F(np.floor(nyquist / max(freq, F(1e-6))))
    prev, curr, acc = F(-sin1), sin1, F(0.0)
    for k in range((max_harmonics + 1) // 2):
        i = F(2.0 * k + 1.0)
        hfreq = F(freq * i)
        ratio = F(hfreq / nyquist)
        t = F((ratio - 0.75) * 4.0)
        taper = F(1.0 - t * t) if ratio > 0.75 else F(1.0)
        gain = F(taper / F(i * i))
        if (i <= max_i) and (hfreq <= nyquist):
            acc = F(acc + F(gain * curr))
        prev, curr = curr, F(F(cos2x2 * curr) - prev)
    return acc


class TomOracle:
    def __init__(self, config: dict, sample_rate=44100.0, coeff=None,
                 max_harmonics=128):
        from libgooey_tpu.core.smoother import smoothing_coeff

        self.sr = float(sample_rate)
        c = coeff if coeff is not None else float(
            np.asarray(smoothing_coeff(sample_rate)))
        self.p = {n: _Smoother(min(max(config.get(n, 0.5), 0.0), 1.0), c)
                  for n in PARAM_NAMES}
        self.max_harmonics = int(max_harmonics)
        self.trig_sample = -(2**30)
        self.vel = F(1.0)
        self.d = F(0.4)
        self.ad = F(0.8)
        self.ac = F(1.0)
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
            scale = F(0.5 + 0.5 * v)
            self.vel = v
            self.d = F(denorm(self.p["decay"].cur, *DECAY_RANGE) * scale)
            self.ad = F(denorm(self.p["amp_decay"].cur, *AMP_DECAY_RANGE)
                        * scale)
            ac = denorm(self.p["amp_decay_curve"].cur, *CURVE_RANGE)
            self.ac = F(1.0) if abs(ac - 1.0) < 0.01 else ac
            self.trig_sample = self.n
            self._pending = None

        for s in self.p.values():
            s.tick()

        idx = F(self.n - self.trig_sample)
        elapsed = F(idx * F(1.0 / self.sr))
        d, ad, ac = self.d, self.ad, self.ac

        freq = denorm(self.p["frequency"].cur, *FREQ_RANGE)
        volume = self.p["volume"].cur
        pitch_mult = F(1.0 + self.p["pitch_drop"].cur * F(1.0))

        pitch_env = adsr_amp(elapsed, 0.001, F(d * F(0.4)), F(0.0))
        fmult = F(1.0 + F(pitch_mult - 1.0) * pitch_env)

        tonal_env = adsr_amp(elapsed, 0.001, F(d * F(0.9)), F(0.0))
        tonal = F(F(np.sin(F(F(idx * F(freq * fmult)) * F(TWO_PI / self.sr))))
                  * tonal_env * F(self.p["tonal"].cur * volume))

        punch_env = adsr_amp(elapsed, 0.001, F(d * F(0.3)), F(0.0))
        punch_freq = F(F(freq * F(3.0)) * F(1.0 + F(fmult - 1.0) * F(0.5)))
        punch_raw = triangle_additive(idx, punch_freq, self.sr,
                                      self.max_harmonics)
        punch = F(punch_raw * punch_env
                  * F(self.p["punch"].cur * volume * F(0.6)))

        # master amp env: attack curve 0.5, curved decay (tom.rs tick)
        amp_env = adsr_amp(elapsed, 0.001, max(ad, F(0.001)), F(0.0),
                           0.5, ac)
        out = F(F(tonal + punch) * amp_env * F(np.sqrt(self.vel)))
        self.n += 1
        return float(out)
