"""Closed-form small polynomial roots (port of
``boofcv_tpu/geo/smalllinalg.py``: ``_cbrt``, ``cubic_roots``,
``quartic_roots``).

Branchless ``torch.where`` throughout, so a batch of K systems is one
sequence of elementwise kernels.  The ``1e-300`` guards are kept as they
are: in float32 they round to 0 exactly as in the reference.
"""

from __future__ import annotations

import math

import torch


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
