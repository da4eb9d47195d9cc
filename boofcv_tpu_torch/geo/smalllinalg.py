"""Closed-form small-matrix algebra and polynomial roots (port of
``boofcv_tpu/geo/smalllinalg.py``, whole).

Branchless ``torch.where`` throughout, so a batch of K systems is one
sequence of elementwise kernels.  The ``1e-300`` guards are kept as they
are: in float32 they round to 0 exactly as in the reference.

``solve_spd`` and ``inv_spd`` work on the symmetric part ``(A + A^T)/2``:
``jnp.linalg.eigh`` symmetrizes its input by default, while PyTorch's
factorizations read one triangle.  ``solve_spd`` factors it with
``cholesky_ex``, which keeps the factorization's status on the device (no
host sync, where ``torch.linalg.eigh`` checks its status on the host); the
reference solves through ``eigh``, and for a positive definite A the two
agree to rounding.  A matrix that is not positive definite gives NaN here.
``inv_spd`` keeps the reference's ``eigh``.  ``poly_roots`` keeps the
reference's (re, im) pairs and its order of operations; each of its 120
iterations is about a hundred small launches (no host sync).
"""

from __future__ import annotations

import math

import torch


def det2(A: torch.Tensor) -> torch.Tensor:
    return A[..., 0, 0] * A[..., 1, 1] - A[..., 0, 1] * A[..., 1, 0]


def inv2(A: torch.Tensor) -> torch.Tensor:
    d = det2(A)
    ds = torch.where(torch.abs(d) < 1e-300, 1e-300, d)
    out = torch.stack([
        torch.stack([A[..., 1, 1], -A[..., 0, 1]], dim=-1),
        torch.stack([-A[..., 1, 0], A[..., 0, 0]], dim=-1),
    ], dim=-2)
    return out / ds[..., None, None]


def det3(A: torch.Tensor) -> torch.Tensor:
    return (A[..., 0, 0] * (A[..., 1, 1] * A[..., 2, 2] - A[..., 1, 2] * A[..., 2, 1])
            - A[..., 0, 1] * (A[..., 1, 0] * A[..., 2, 2] - A[..., 1, 2] * A[..., 2, 0])
            + A[..., 0, 2] * (A[..., 1, 0] * A[..., 2, 1] - A[..., 1, 1] * A[..., 2, 0]))


def inv3(A: torch.Tensor) -> torch.Tensor:
    """Adjugate 3x3 inverse, batched over leading axes.  The determinant
    guard is the reference's ``1e-300``: live in float64, and in float32 a
    constant that rounds to 0, so a singular float32 block divides by its
    own (zero) determinant there as here."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    C00 = e * i - f * h
    C01 = -(d * i - f * g)
    C02 = d * h - e * g
    C10 = -(b * i - c * h)
    C11 = a * i - c * g
    C12 = -(a * h - b * g)
    C20 = b * f - c * e
    C21 = -(a * f - c * d)
    C22 = a * e - b * d
    det = a * C00 + b * C01 + c * C02
    ds = torch.where(torch.abs(det) < 1e-300, 1e-300, det)
    adjT = torch.stack([
        torch.stack([C00, C10, C20], dim=-1),
        torch.stack([C01, C11, C21], dim=-1),
        torch.stack([C02, C12, C22], dim=-1),
    ], dim=-2)
    return adjT / ds[..., None, None]


def solve33(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3] @ x = [..., 3] via the adjugate inverse."""
    return (inv3(A) @ b[..., None])[..., 0]


# matrices one batched eigh call takes on the card: torch 2.11's
# cusolverDnXsyevBatched refuses 32,767 or more 3x3, 4x4 or 9x9 matrices
# (CUSOLVER_STATUS_INVALID_VALUE at its workspace query; 24,576 pass), so
# larger batches go in chunks, one host sync each
_EIGH_BATCH = 1 << 14


def _eigh_sym(A: torch.Tensor):
    """(w, V) of the symmetric part of A [..., n, n], ascending, as
    ``jnp.linalg.eigh`` (symmetrize_input) gives them."""
    S = 0.5 * (A + A.transpose(-1, -2))
    lead = S.shape[:-2]
    count = math.prod(lead)
    if S.device.type != "cuda" or count <= _EIGH_BATCH:
        return torch.linalg.eigh(S)
    flat = S.reshape((count,) + S.shape[-2:])
    parts = [torch.linalg.eigh(flat[i:i + _EIGH_BATCH])
             for i in range(0, count, _EIGH_BATCH)]
    return (torch.cat([w for w, _ in parts]).reshape(S.shape[:-1]),
            torch.cat([v for _, v in parts]).reshape(S.shape))


def solve_spd(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """SPD solve by the Cholesky factor of A's symmetric part, NaN where
    the factorization fails.  A: [..., N, N], b: [..., N]."""
    L, info = torch.linalg.cholesky_ex(0.5 * (A + A.transpose(-1, -2)))
    L = torch.where((info == 0)[..., None, None], L, float("nan"))
    return torch.cholesky_solve(b[..., None], L)[..., 0]


def inv_spd(A: torch.Tensor) -> torch.Tensor:
    w, Q = _eigh_sym(A)
    ws = torch.where(torch.abs(w) < 1e-300, 1e-300, w)
    return torch.einsum("...ik,...k,...jk->...ij", Q, 1.0 / ws, Q)


def _cbrt(x: torch.Tensor) -> torch.Tensor:
    return torch.sign(x) * torch.abs(x) ** (1.0 / 3.0)


def cubic_roots(a3, a2, a1, a0):
    """Real roots of a3 x^3 + a2 x^2 + a1 x + a0 (Cardano), batched.
    Returns (roots [..., 3], real_mask [..., 3])."""
    a3s = torch.where(torch.abs(a3) < 1e-300, 1e-300, a3)
    b, c, d = a2 / a3s, a1 / a3s, a0 / a3s
    p = c - b * b / 3.0
    q = 2.0 * b ** 3 / 27.0 - b * c / 3.0 + d
    disc = (q / 2.0) ** 2 + (p / 3.0) ** 3
    shift = -b / 3.0

    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    u = _cbrt(-q / 2.0 + sq)
    v = _cbrt(-q / 2.0 - sq)
    r_single = u + v + shift

    pm = torch.clamp(p, max=-1e-300)
    m = 2.0 * torch.sqrt(-pm / 3.0)
    arg = torch.clamp(3.0 * q / (pm * m), -1.0, 1.0)
    theta = torch.arccos(arg) / 3.0
    # float64 like the reference's ``jnp.arange(3.0)`` under x64: it
    # promotes the three-root branch (and so the quartic's back half) to
    # float64 even for float32 coefficients, and the port keeps that
    k = torch.arange(3.0, dtype=torch.float64, device=p.device)
    r_triple = (m[..., None] * torch.cos(theta[..., None]
                                         - 2.0 * math.pi * k / 3.0)
                + shift[..., None])

    single = (disc > 0)[..., None]
    zeros2 = torch.zeros_like(r_triple[..., :2])
    roots = torch.where(single,
                        torch.cat([r_single[..., None], zeros2], -1),
                        r_triple)
    real = torch.where(single,
                       torch.cat([torch.ones_like(single),
                                  torch.zeros_like(zeros2, dtype=torch.bool)],
                                 -1),
                       torch.ones_like(r_triple, dtype=torch.bool))
    return roots, real


def quartic_roots(c4, c3, c2, c1, c0):
    """Real roots of a quartic (Ferrari's method), batched.
    Returns (roots [..., 4], real_mask [..., 4])."""
    c4s = torch.where(torch.abs(c4) < 1e-300, 1e-300, c4)
    a, b, c, d = c3 / c4s, c2 / c4s, c1 / c4s, c0 / c4s
    p = b - 3.0 * a * a / 8.0
    q = c - a * b / 2.0 + a ** 3 / 8.0
    r = d - a * c / 4.0 + a * a * b / 16.0 - 3.0 * a ** 4 / 256.0
    shift = -a / 4.0

    mroots, mreal = cubic_roots(torch.ones_like(p), p,
                                p * p / 4.0 - r, -q * q / 8.0)
    mcand = torch.where(mreal, mroots, float("-inf"))
    m = torch.amax(mcand, dim=-1)
    m = torch.clamp(m, min=1e-300)

    sqrt2m = torch.sqrt(2.0 * m)
    qs = torch.where(torch.abs(sqrt2m) < 1e-300, 1e-300, sqrt2m)
    C_plus = p / 2.0 + m - q / (2.0 * qs)
    C_minus = p / 2.0 + m + q / (2.0 * qs)

    def quad(sgn_b, C):
        disc = m / 2.0 - C
        ok = disc >= 0
        sq = torch.sqrt(torch.clamp(disc, min=0.0))
        return -sgn_b * qs / 2.0 + sq, -sgn_b * qs / 2.0 - sq, ok

    y1, y2, ok12 = quad(1.0, C_plus)
    y3, y4, ok34 = quad(-1.0, C_minus)
    roots = torch.stack([y1, y2, y3, y4], dim=-1) + shift[..., None]
    real = torch.stack([ok12, ok12, ok34, ok34], dim=-1)
    return roots, real


def poly_roots(coeffs: torch.Tensor, iters: int = 120):
    """Batched all-roots of a real-coefficient polynomial (Durand-Kerner),
    as the reference computes them: float64 (re, im) pairs, a Cauchy-bound
    start circle with angles offset by 0.4, ``iters`` fixed iterations.

    coeffs: [..., D+1] highest degree first.  Returns (re [..., D],
    im [..., D]); the caller decides which roots are real.  Degenerate
    leading coefficients give garbage roots: guard upstream."""
    c = coeffs.to(torch.float64)
    lead = c[..., :1]
    c = c / torch.where(torch.abs(lead) < 1e-300, 1e-300, lead)
    D = c.shape[-1] - 1
    r = 1.0 + torch.amax(torch.abs(c[..., 1:]), dim=-1)
    k = torch.arange(D, dtype=torch.float64, device=c.device)
    ang = 2.0 * math.pi * k / D + 0.4
    zr = r[..., None] * torch.cos(ang)
    zi = r[..., None] * torch.sin(ang)
    off_diag = ~torch.eye(D, dtype=torch.bool, device=c.device)
    for _ in range(iters):
        pr = c[..., 0:1].expand(zr.shape)
        pi = torch.zeros_like(zr)
        for i in range(1, D + 1):
            pr, pi = pr * zr - pi * zi + c[..., i:i + 1], pr * zi + pi * zr
        # prod_{j != i} (z_i - z_j), multiplied in the order j = 0 .. D-1
        dr = torch.where(off_diag, zr[..., :, None] - zr[..., None, :], 1.0)
        di = torch.where(off_diag, zi[..., :, None] - zi[..., None, :], 0.0)
        qr = torch.ones_like(zr)
        qi = torch.zeros_like(zr)
        for j in range(D):
            drj, dij = dr[..., j], di[..., j]
            qr, qi = qr * drj - qi * dij, qr * dij + qi * drj
        den = qr * qr + qi * qi
        den = torch.where(den < 1e-300, 1e-300, den)
        zr, zi = (zr - (pr * qr + pi * qi) / den,
                  zi - (pi * qr - pr * qi) / den)
    return zr, zi
