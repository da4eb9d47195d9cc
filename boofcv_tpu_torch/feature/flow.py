"""Dense optical flow: Horn-Schunck, single level and coarse to fine (port of
``boofcv_tpu/feature/flow.py``'s ``horn_schunck`` and
``horn_schunck_pyramid``).

Reference analog: boofcv-feature alg/flow/HornSchunck.java and
HornSchunckPyramid.java (variational).

Horn-Schunck's Jacobi relaxation is an elementwise stencil iterated a fixed
number of times; each iteration pads a field once (edge-replicated) and
reads its eight neighbours as views of the padded copy.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from boofcv_tpu_torch.core.pyramid import PyramidConfig
from boofcv_tpu_torch.ip import pyramid_ops
from boofcv_tpu_torch.ip.interpolate import bilinear


def _pad_edge(f: torch.Tensor) -> torch.Tensor:
    return F.pad(f[None], (1, 1, 1, 1), mode="replicate")[0]


def _shifted(p: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """The field whose 1-px edge-replicated copy is ``p``, sampled at
    (y+dy, x+dx)."""
    h, w = p.shape[0] - 2, p.shape[1] - 2
    return p[1 + dy: 1 + dy + h, 1 + dx: 1 + dx + w]


def _shift_edge(f: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """f sampled at (y+dy, x+dx) with EDGE clamping (a roll would wrap
    opposite edges together and invent brightness constraints at the
    borders)."""
    return _shifted(_pad_edge(f), dy, dx)


def _gradients_hs(i1, i2):
    """Horn-Schunck derivative estimates: central differences averaged over
    the two frames (HornSchunck.java's kernel)."""
    p1, p2 = _pad_edge(i1), _pad_edge(i2)
    dx = 0.5 * (_shifted(p1, 0, 1) - _shifted(p1, 0, -1)
                + _shifted(p2, 0, 1) - _shifted(p2, 0, -1)) * 0.5
    dy = 0.5 * (_shifted(p1, 1, 0) - _shifted(p1, -1, 0)
                + _shifted(p2, 1, 0) - _shifted(p2, -1, 0)) * 0.5
    return dx, dy, i2 - i1


def _laplacian_avg(f):
    """6/12-weighted neighbourhood average used by Horn-Schunck."""
    p = _pad_edge(f)
    up, dn = _shifted(p, -1, 0), _shifted(p, 1, 0)
    lf, rt = _shifted(p, 0, -1), _shifted(p, 0, 1)
    d1, d2 = _shifted(p, -1, -1), _shifted(p, -1, 1)
    d3, d4 = _shifted(p, 1, -1), _shifted(p, 1, 1)
    return (up + dn + lf + rt) / 6.0 + (d1 + d2 + d3 + d4) / 12.0


def horn_schunck(image1, image2, alpha: float = 20.0,
                 iterations: int = 200, init_flow=None):
    """Single-level Horn-Schunck (HornSchunck.java).  Returns (u, v)."""
    i1 = image1.to(torch.float32)
    i2 = image2.to(torch.float32)
    dx, dy, dt = _gradients_hs(i1, i2)
    if init_flow is None:
        u, v = torch.zeros_like(i1), torch.zeros_like(i1)
    else:
        u, v = init_flow
    den = alpha * alpha + dx * dx + dy * dy
    for _ in range(iterations):
        ub = _laplacian_avg(u)
        vb = _laplacian_avg(v)
        num = dx * ub + dy * vb + dt
        u = ub - dx * num / den
        v = vb - dy * num / den
    return u, v


def _warp_image(image, u, v):
    h, w = image.shape
    ys, xs = torch.meshgrid(
        torch.arange(h, dtype=torch.float32, device=image.device),
        torch.arange(w, dtype=torch.float32, device=image.device),
        indexing="ij")
    return bilinear(image, ys + v, xs + u)


def horn_schunck_pyramid(image1, image2, alpha: float = 20.0,
                         iterations: int = 100,
                         scales=(1, 2, 4, 8)):
    """Coarse-to-fine Horn-Schunck with warping (HornSchunckPyramid.java).
    Returns (u, v) at full resolution."""
    cfg = PyramidConfig(scales=tuple(scales))
    p1 = pyramid_ops.pyramid_average(image1.to(torch.float32), cfg)
    p2 = pyramid_ops.pyramid_average(image2.to(torch.float32), cfg)
    u = torch.zeros_like(p1[-1])
    v = torch.zeros_like(p1[-1])
    for lvl in range(len(scales) - 1, -1, -1):
        i1, i2 = p1[lvl], p2[lvl]
        if u.shape != i1.shape:
            ratio = scales[lvl + 1] / scales[lvl]
            h, w = i1.shape
            dev = i1.device
            yy, xx = torch.meshgrid(
                torch.arange(h, dtype=torch.float32, device=dev) / ratio,
                torch.arange(w, dtype=torch.float32, device=dev) / ratio,
                indexing="ij")
            u = bilinear(u, yy, xx) * ratio
            v = bilinear(v, yy, xx) * ratio
        # warp the second image by the current flow, solve for the rest
        du, dv = horn_schunck(i1, _warp_image(i2, u, v), alpha, iterations)
        u = u + du
        v = v + dv
    return u, v
