"""Reed-Solomon codes over GF(2^8) (QR flavor: first root = alpha^0) (port of
``boofcv_tpu/recognition/qr/reed_solomon.py``, whole: the reference's Python and
numpy, copied).

Reference analog: boofcv-recognition alg/fiducial/qrcode/
ReidSolomonCodes.java — generator-polynomial encoding, syndromes,
Berlekamp-Massey error locator, Chien search, Forney magnitudes.

Polynomials are Python lists, HIGHEST degree first (matching the classic
presentations of the algorithm).
"""

from __future__ import annotations

from boofcv_tpu_torch.recognition.qr.galois import GF256


def _poly_add(gf, p, q):
    r = [0] * max(len(p), len(q))
    for i, c in enumerate(p):
        r[i + len(r) - len(p)] = c
    for i, c in enumerate(q):
        r[i + len(r) - len(q)] ^= c
    return r


def _poly_scale(gf, p, s):
    return [gf.mul(c, s) for c in p]


def _poly_div(gf, dividend, divisor):
    out = list(dividend)
    for i in range(len(dividend) - (len(divisor) - 1)):
        c = out[i]
        if c != 0:
            for j in range(1, len(divisor)):
                if divisor[j] != 0:
                    out[i + j] ^= gf.mul(divisor[j], c)
    sep = -(len(divisor) - 1)
    return out[:sep], out[sep:]


class ReedSolomon:
    def __init__(self, n_ecc: int, gf: GF256 | None = None):
        self.gf = gf or GF256()
        self.n_ecc = n_ecc
        g = [1]
        for i in range(n_ecc):
            g = self.gf.poly_mul(g, [1, self.gf.pow(2, i)])
        self.generator = g

    def encode(self, message):
        """ECC symbols for the message bytes."""
        _, remainder = _poly_div(self.gf, list(message) + [0] * self.n_ecc,
                                 self.generator)
        return remainder

    def _syndromes(self, received):
        gf = self.gf
        return [gf.poly_eval(received, gf.pow(2, i))
                for i in range(self.n_ecc)]

    def _find_error_locator(self, synd):
        gf = self.gf
        err_loc = [1]
        old_loc = [1]
        for i in range(self.n_ecc):
            delta = synd[i]
            for j in range(1, len(err_loc)):
                delta ^= gf.mul(err_loc[-(j + 1)], synd[i - j])
            old_loc = old_loc + [0]
            if delta != 0:
                if len(old_loc) > len(err_loc):
                    new_loc = _poly_scale(gf, old_loc, delta)
                    old_loc = _poly_scale(gf, err_loc, gf.inverse(delta))
                    err_loc = new_loc
                err_loc = _poly_add(gf, err_loc,
                                    _poly_scale(gf, old_loc, delta))
        # strip leading zeros
        while len(err_loc) > 1 and err_loc[0] == 0:
            err_loc = err_loc[1:]
        return err_loc

    def _find_errors(self, err_loc, n):
        """Chien search: message positions of the errors."""
        gf = self.gf
        errs = len(err_loc) - 1
        rev = err_loc[::-1]  # roots of the reversed locator are X_i = 2^coef
        pos = []
        for i in range(n):
            if gf.poly_eval(rev, gf.pow(2, i)) == 0:
                pos.append(n - 1 - i)
        if len(pos) != errs:
            return None
        return pos

    def decode(self, received):
        """Returns (corrected codeword, n_errors) or (None, -1)."""
        gf = self.gf
        received = list(received)
        synd = self._syndromes(received)
        if max(synd) == 0:
            return received, 0
        err_loc = self._find_error_locator(synd)
        n_err = len(err_loc) - 1
        if n_err * 2 > self.n_ecc:
            return None, -1
        pos = self._find_errors(err_loc, len(received))
        if pos is None:
            return None, -1
        out = self._correct_errata(received, synd, pos)
        if out is None or max(self._syndromes(out)) != 0:
            return None, -1
        return out, n_err

    def _correct_errata(self, msg, synd, err_pos):
        gf = self.gf
        n = len(msg)
        coef_pos = [n - 1 - p for p in err_pos]
        # errata locator from known positions
        loc = [1]
        for i in coef_pos:
            loc = gf.poly_mul(loc, _poly_add(gf, [1], [gf.pow(2, i), 0]))
        # error evaluator: (t*S(t) * loc) mod x^(len(loc)) — the syndrome
        # polynomial enters shifted one power (leading-zero pad)
        synd_p = [0] + list(synd)
        _, err_eval = _poly_div(gf, gf.poly_mul(synd_p[::-1], loc),
                                [1] + [0] * (len(loc)))
        X = [gf.pow(2, -(255 - i) % 255) for i in coef_pos]
        # Forney
        out = list(msg)
        for i, Xi in enumerate(X):
            Xi_inv = gf.inverse(Xi)
            prime = 1
            for j, Xj in enumerate(X):
                if j != i:
                    prime = gf.mul(prime, 1 ^ gf.mul(Xi_inv, Xj))
            if prime == 0:
                return None
            y = gf.mul(Xi, gf.poly_eval(err_eval, Xi_inv))
            out[err_pos[i]] ^= gf.div(y, prime)
        return out
