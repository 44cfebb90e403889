"""Per-sample scalar oracle of ops/oversample.py (hiir-style polyphase).

Mirrors the device implementation exactly — same coefficients (STAGE1/STAGE2),
same phase split, same allpass recurrence y = a*x + x_prev - a*y_prev,
same odd-phase one-sample delay in the decimator — so oracles that chain
nonlinearities through 4x oversampling match render_block bit-for-float.
"""

import numpy as np

from libgooey_tpu.ops.oversample import STAGE1, STAGE2


class AllpassChain:
    def __init__(self, coefs):
        self.coefs = list(coefs)
        self.y = [0.0] * len(coefs)
        self.x = [0.0] * len(coefs)

    def tick(self, s):
        s = np.float32(s)
        for i, a in enumerate(self.coefs):
            a = np.float32(a)
            y = np.float32(a * s + self.x[i] - a * self.y[i])
            self.x[i] = s
            self.y[i] = y
            s = y
        return s


class HalfbandUp:
    def __init__(self, coefs):
        self.a0 = AllpassChain(coefs[0::2])
        self.a1 = AllpassChain(coefs[1::2])

    def tick(self, s):
        return self.a0.tick(s), self.a1.tick(s)  # (even, odd)


class HalfbandDown:
    def __init__(self, coefs):
        self.a0 = AllpassChain(coefs[0::2])
        self.a1 = AllpassChain(coefs[1::2])
        self.x1 = np.float32(0.0)

    def tick(self, even, odd):
        out = np.float32(0.5) * (self.a0.tick(even) + self.a1.tick(self.x1))
        self.x1 = np.float32(odd)
        return out


class OracleOversampler:
    """mode in (1, 2, 4); process(x, fn) -> one engine-rate sample."""

    def __init__(self, mode=4):
        self.mode = mode
        self.up1 = HalfbandUp(STAGE1)
        self.up2 = HalfbandUp(STAGE2)
        self.down2 = HalfbandDown(STAGE2)
        self.down1 = HalfbandDown(STAGE1)

    def process(self, x, fn):
        if self.mode == 1:
            return np.float32(fn(np.float32(x)))
        e, o = self.up1.tick(x)
        if self.mode == 2:
            return self.down1.tick(np.float32(fn(e)), np.float32(fn(o)))
        hi = self.up2.tick(e) + self.up2.tick(o)       # 4 samples
        y = [np.float32(fn(v)) for v in hi]
        d0 = self.down2.tick(y[0], y[1])
        d1 = self.down2.tick(y[2], y[3])
        return self.down1.tick(d0, d1)
