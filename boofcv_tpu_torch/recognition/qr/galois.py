"""GF(2^8) arithmetic (table-based) (port of
``boofcv_tpu/recognition/qr/galois.py``, whole: the reference's Python and
numpy, copied).

Reference analog: boofcv-recognition alg/fiducial/qrcode/
GaliosFieldTableOps.java — exp/log tables over the QR polynomial 0x11D.
"""

from __future__ import annotations

import numpy as np


class GF256:
    def __init__(self, primitive: int = 0x11D):
        self.exp = np.zeros(512, np.int32)
        self.log = np.zeros(256, np.int32)
        x = 1
        for i in range(255):
            self.exp[i] = x
            self.log[x] = i
            x <<= 1
            if x & 0x100:
                x ^= primitive
        for i in range(255, 512):
            self.exp[i] = self.exp[i - 255]

    def mul(self, a: int, b: int) -> int:
        if a == 0 or b == 0:
            return 0
        return int(self.exp[self.log[a] + self.log[b]])

    def div(self, a: int, b: int) -> int:
        if b == 0:
            raise ZeroDivisionError
        if a == 0:
            return 0
        return int(self.exp[(self.log[a] - self.log[b]) % 255])

    def pow(self, a: int, n: int) -> int:
        if a == 0:
            return 0
        return int(self.exp[(self.log[a] * n) % 255])

    def inverse(self, a: int) -> int:
        return int(self.exp[255 - self.log[a]])

    # polynomial ops (coefficient lists, highest degree first)
    def poly_mul(self, p, q):
        out = [0] * (len(p) + len(q) - 1)
        for i, a in enumerate(p):
            for j, b in enumerate(q):
                out[i + j] ^= self.mul(a, b)
        return out

    def poly_eval(self, p, x):
        y = 0
        for c in p:
            y = self.mul(y, x) ^ c
        return y
