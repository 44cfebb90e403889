"""Per-sample scalar oracle for the bass bank (bass.rs semantics as realized
by libgooey_tpu.instruments.bass.render_block — verified to <2e-4)."""

import numpy as np

from oversample_oracle import OracleOversampler

F = np.float32
TWO_PI = F(2.0 * np.pi)

FREQ_RANGE = (30.0, 200.0)
DETUNE_RANGE = (0.0, 30.0)
CUTOFF_RANGE = (20.0, 18_000.0)
RES_RANGE = (0.5, 15.0)
FENV_DECAY_RANGE = (0.01, 2.0)
FENV_CURVE_RANGE = (0.1, 8.0)
AMP_DECAY_RANGE = (0.05, 4.0)
AMP_CURVE_RANGE = (0.1, 10.0)

PARAM_NAMES = (
    "frequency", "sub_level", "osc_level", "detune_level", "detune_amount",
    "osc_shape", "filter_cutoff", "filter_resonance", "filter_env_amount",
    "filter_env_decay", "filter_env_curve", "amp_decay", "amp_decay_curve",
    "overdrive", "volume", "tuning",
)


def denorm(x, lo, hi):
    return F(lo + min(max(x, 0.0), 1.0) * (hi - lo))


def exp_denorm(x, lo, hi):
    return F(lo * (hi / lo) ** min(max(x, 0.0), 1.0))


def tuning_mult(x):
    return F(2.0 ** (((min(max(x, 0.0), 1.0) - 0.5) * 24.0) / 12.0))


class ExactPhase:
    """Causal per-sample mirror of ``ops.scan.phase_cumsum_reset``.

    The bank computes mod-1 oscillator phase per block with a
    split-increment formulation (``inc0 = hi + lo`` with ``hi`` on a
    2^-11 grid, exact hi-ramp mod-1, f32 residual cumsum, reset-base
    latch).  Replaying the SAME arithmetic here makes the oracle's wrap
    samples land on the same side as the bank's, which closes the old
    ±2.5-sample polyBLEP exclusion windows: inside a correction window
    the slope ~2/inc amplified any phase difference (f64 serial vs f32
    tree) into ~1e-3 spikes; with identical phase trajectories the bank
    matches the oracle pointwise everywhere."""

    def __init__(self, block_size):
        self.B = int(block_size)
        self.carry = F(0.0)
        self.j = 0

    def tick(self, inc, reset):
        inc = F(inc)
        if self.j == 0:
            self.inc0 = inc
            self.hi = F(np.floor(F(inc * F(2048.0))) * F(1.0 / 2048.0))
            self.lo = F(self.inc0 - self.hi)       # exact (Sterbenz)
            self.resid = F(0.0)
            self.base = F(-self.carry)             # linrec1 y0 = -carry
            self.p_prev = F(0.0)
        self.resid = F(self.resid + F(inc - self.inc0))
        n1 = F(self.j + 1)
        ramp_hi = F(self.hi * n1)                  # exact: 2^-11 grid
        ramp_hi = F(ramp_hi - np.floor(ramp_hi))   # exact mod-1
        ramp = F(ramp_hi + F(self.lo * n1))
        p = F(np.mod(F(ramp + self.resid), F(1.0)))
        if reset:
            self.base = self.p_prev
        self.p_prev = p
        phase = F(np.mod(F(p - self.base), F(1.0)))
        self.j += 1
        if self.j == self.B:
            self.carry = phase
            self.j = 0
        return float(phase)


def poly_blep(t, dt):
    dt = max(dt, 1e-12)
    if t < dt:
        e = t / dt
        return F(2.0 * e - e * e - 1.0)
    if t > 1.0 - dt:
        l = (t - 1.0) / dt
        return F(l * l + 2.0 * l + 1.0)
    return F(0.0)


def env_amp(elapsed, attack, decay, curve):
    """Sustain-0 power-curve envelope (core.envelope.amplitude)."""
    if elapsed < 0.0:
        return F(0.0)
    c = min(max(curve, 0.1), 10.0)
    if elapsed < attack:
        return F(max(elapsed / attack, 0.0) ** 1.0)
    if elapsed < attack + decay:
        prog = max((elapsed - attack) / decay, 0.0) ** c
        return F(1.0 - prog)
    return F(0.0)


class BassOracle:
    def __init__(self, config: dict, sample_rate=44100.0, coeff=None,
                 block_size=512):
        from libgooey_tpu.core.smoother import smoothing_coeff

        self.sr = sample_rate
        self.q = F(1.0 - (coeff if coeff is not None else
                          float(np.asarray(smoothing_coeff(sample_rate)))))
        self.cur = {n: F(min(max(config.get(n, 0.5), 0.0), 1.0))
                    for n in PARAM_NAMES}
        self.tgt = dict(self.cur)
        self.trig_sample = -(2**30)
        self.vel = F(1.0)
        self.freq0 = denorm(self.cur["frequency"], *FREQ_RANGE)
        self.ad = F(1.0)
        self.ac = F(1.0)
        self.fd = F(0.3)
        self.fc = F(1.0)
        # exact split-increment mod-1 phase, the bank's own formulation
        # (ops.scan.phase_cumsum_reset; the reference keeps f64 phases,
        # bass.rs — both track the exact recurrence to ~1e-7 cycles, and
        # sharing the bank's arithmetic makes the comparison pointwise)
        self._sub = ExactPhase(block_size)
        self._osc = ExactPhase(block_size)
        self._det = ExactPhase(block_size)
        self.sub_phase = 0.0
        self.osc_phase = 0.0
        self.det_phase = 0.0
        self.ic1 = F(0.0)
        self.ic2 = F(0.0)
        self.ovs = OracleOversampler(4)
        self.n = 0
        #: per-tick (osc_phase, det_phase, osc_inc, det_inc) for blep-window
        #: masking in tests (tree-vs-serial f32 phase rounding is amplified
        #: ~1/dt inside the correction window — a comparison artifact)
        self.phase_trace = []

    def set_param(self, name, value):
        self.tgt[name] = F(min(max(value, 0.0), 1.0))

    def trigger(self, velocity):
        """Queue a trigger for the *next* sample processed."""
        self._pending = F(min(max(velocity, 0.0), 1.0))

    def tick(self):
        # trigger latch reads the PRE-tick smoother state (VoiceBlock.vat)
        if getattr(self, "_pending", None) is not None:
            self.vel = self._pending
            self.freq0 = denorm(self.cur["frequency"], *FREQ_RANGE)
            self.ad = denorm(self.cur["amp_decay"], *AMP_DECAY_RANGE)
            self.ac = denorm(self.cur["amp_decay_curve"], *AMP_CURVE_RANGE)
            self.fd = denorm(self.cur["filter_env_decay"], *FENV_DECAY_RANGE)
            self.fc = denorm(self.cur["filter_env_curve"], *FENV_CURVE_RANGE)
            self.trig_sample = self.n
            reset = True
            self._pending = None
        else:
            reset = False

        # one-pole smoother tick with the settle snap (smoother.rs:120-137)
        for name in PARAM_NAMES:
            delta = F((self.cur[name] - self.tgt[name]) * self.q)
            self.cur[name] = self.tgt[name] + (F(0.0) if abs(delta) < 1e-4
                                               else delta)
        p = self.cur

        elapsed = (self.n - self.trig_sample) / self.sr
        freq = F(self.freq0 * tuning_mult(p["tuning"]))
        det_freq = F(freq * 2.0 ** (denorm(p["detune_amount"], *DETUNE_RANGE)
                                    / 1200.0))
        sub_inc = F(freq / self.sr)
        det_inc = F(det_freq / self.sr)
        self.sub_phase = self._sub.tick(sub_inc, reset)
        self.osc_phase = self._osc.tick(sub_inc, reset)
        self.det_phase = self._det.tick(det_inc, reset)

        sub_out = F(np.sin(self.sub_phase * TWO_PI))
        shape = p["osc_shape"]

        def blep_pair(phase, inc):
            saw = F((2.0 * phase - 1.0) - poly_blep(phase, inc))
            sq = F((1.0 if phase < 0.5 else -1.0) + poly_blep(phase, inc)
                   - poly_blep((phase + 0.5) % 1.0, inc))
            return saw, sq

        self.phase_trace.append((self.osc_phase, self.det_phase,
                                 sub_inc, det_inc))
        saw_m, sq_m = blep_pair(self.osc_phase, sub_inc)
        saw_d, sq_d = blep_pair(self.det_phase, det_inc)
        osc_out = F(saw_m * (1.0 - shape) + sq_m * shape)
        det_out = F(saw_d * (1.0 - shape) + sq_d * shape)
        mix = F(sub_out * p["sub_level"] + osc_out * p["osc_level"]
                + det_out * p["detune_level"])

        # waveshaper: the oversampler is ALWAYS fed (jnp.where evaluates
        # both branches); output selected by the od / drive gates
        od = p["overdrive"]
        drive = F(1.0 + od * 9.0)
        d_eff = F(max(drive, 1.0 + 1e-6))
        comp = F(np.tanh(0.5) / np.tanh(0.5 * d_eff))
        shaped = self.ovs.process(mix, lambda v: np.tanh(v * d_eff) * comp)
        if od > 0.001 and drive > 1.0:
            saturated = F(shaped)
        else:
            saturated = mix

        # swept TPT SVF lowpass
        fenv = env_amp(elapsed, 0.001, self.fd, self.fc)
        base_cut = exp_denorm(p["filter_cutoff"], *CUTOFF_RANGE)
        cutoff = min(max(base_cut + (CUTOFF_RANGE[1] - base_cut)
                         * p["filter_env_amount"] * fenv,
                         CUTOFF_RANGE[0]), CUTOFF_RANGE[1])
        cutoff = min(max(cutoff, 20.0), self.sr * 0.45)
        g = F(np.tan(np.pi * cutoff / self.sr))
        r = F(1.0 / max(denorm(p["filter_resonance"], *RES_RANGE), 0.5))
        hcoef = F(1.0 / (1.0 + r * g + g * g))
        if reset:
            self.ic1 = self.ic2 = F(0.0)
        v1 = F((g * (saturated - self.ic2) + self.ic1) * hcoef)
        v2 = F(self.ic2 + g * v1)
        self.ic1 = F(2.0 * v1 - self.ic1)
        self.ic2 = F(2.0 * v2 - self.ic2)
        lp = v2

        amp = env_amp(elapsed, 0.002, self.ad, self.ac)
        out = F(lp * amp * np.sqrt(self.vel) * p["volume"])
        self.n += 1
        return float(out)
