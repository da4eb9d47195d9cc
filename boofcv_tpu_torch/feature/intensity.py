"""Corner and blob intensity (port of ``boofcv_tpu/feature/intensity.py``).

Reference analog: boofcv-feature alg/feature/detect/intensity/* —
FastCornerDetector.java:67 (FAST), HarrisCornerIntensity.java,
ShiTomasiCornerIntensity.java over ImplSsdCorner's structure tensor,
KitRosCornerIntensity, HessianBlobIntensity, MedianCornerIntensity.

FAST's ring test is a 16-way shifted compare with the circular run length
found over the doubled ring; the structure-tensor detectors are box (or
Gaussian) sums of gradient products and elementwise eigen-maths.  The
unweighted Shi-Tomasi works on [..., H, W]; the rest on [H, W].
"""

from __future__ import annotations

import torch

from boofcv_tpu_torch.core.border import BorderType, pad
from boofcv_tpu_torch.ip import blur as _blur
from boofcv_tpu_torch.ip import convolve
from boofcv_tpu_torch.ip import derivative as _deriv

# Bresenham circle of radius 3, the FAST ring, clockwise from 12 o'clock;
# (dx, dy) pairs
_FAST_RING = ((0, -3), (1, -3), (2, -2), (3, -1), (3, 0), (3, 1), (2, 2),
              (1, 3), (0, 3), (-1, 3), (-2, 2), (-3, 1), (-3, 0), (-3, -1),
              (-2, -2), (-1, -3))


def _ring_stack(image: torch.Tensor) -> torch.Tensor:
    """[16, H, W] of the ring neighbours' values (EXTENDED border)."""
    p = pad(image, 3, 3, BorderType.EXTENDED)
    h, w = image.shape
    return torch.stack([p[3 + dy:3 + dy + h, 3 + dx:3 + dx + w]
                        for dx, dy in _FAST_RING])


def _max_circular_run(mask: torch.Tensor) -> torch.Tensor:
    """Longest circular run of True over the 16 ring slots, as the longest
    run over the ring doubled to 32 slots (capped at 16)."""
    m = torch.cat([mask, mask])
    run = torch.zeros(m.shape[1:], dtype=torch.int32, device=m.device)
    best = run
    for i in range(32):
        run = torch.where(m[i], run + 1, 0)
        best = torch.maximum(best, run)
    return torch.clamp(best, max=16)


def fast(image: torch.Tensor, pixel_tol: float = 20.0,
         min_continuous: int = 9):
    """FAST corner intensity (FastCornerDetector.java).  Returns (intensity,
    is_corner): a corner where a circular run of ``min_continuous`` ring
    pixels is all brighter (or all darker) than the centre by more than
    ``pixel_tol``; its intensity the larger of the two sums of
    |ring - centre| - tol over the brighter and over the darker pixels,
    0 elsewhere."""
    img = image.to(torch.float32)
    ring = _ring_stack(img)
    center = img[None]
    brighter = ring > center + pixel_tol
    darker = ring < center - pixel_tol
    corner = ((_max_circular_run(brighter) >= min_continuous)
              | (_max_circular_run(darker) >= min_continuous))
    diff = torch.abs(ring - center) - pixel_tol
    score_b = torch.sum(torch.where(brighter, diff, 0.0), dim=0)
    score_d = torch.sum(torch.where(darker, diff, 0.0), dim=0)
    intensity = torch.where(corner, torch.maximum(score_b, score_d), 0.0)
    return intensity, corner


def _box_sum(image: torch.Tensor, radius: int) -> torch.Tensor:
    """(2r+1)^2 box sum with an EXTENDED border, as separable shifted adds
    (horizontal then vertical, like the reference's two 1-D passes)."""
    h, w = image.shape[-2:]
    n = 2 * radius + 1
    p = convolve.pad_planes(image, radius, radius, BorderType.EXTENDED)
    t = p[..., 0:w]
    for k in range(1, n):
        t = t + p[..., k:k + w]
    out = t[..., 0:h, :]
    for k in range(1, n):
        out = out + t[..., k:k + h, :]
    return out


def _structure_tensor(image: torch.Tensor, radius: int = 2,
                      weighted: bool = False):
    """Sums of (dx^2, dxdy, dy^2) over a (2r+1) window (ImplSsdCorner), or
    with ``weighted`` Gaussian-weighted sums of that radius."""
    dx, dy = _deriv.sobel(image)
    xx, xy, yy = dx * dx, dx * dy, dy * dy
    if weighted:
        return tuple(_blur.gaussian(c, radius=radius,
                                    border=BorderType.EXTENDED)
                     for c in (xx, xy, yy))
    return _box_sum(xx, radius), _box_sum(xy, radius), _box_sum(yy, radius)


def shi_tomasi(image: torch.Tensor, radius: int = 2,
               weighted: bool = False) -> torch.Tensor:
    """Shi-Tomasi min-eigenvalue intensity (ShiTomasiCornerIntensity.java)
    of an [..., H, W] image ([H, W] when ``weighted``)."""
    sxx, sxy, syy = _structure_tensor(image, radius, weighted)
    tr_half = (sxx + syy) * 0.5
    det_part = torch.sqrt(torch.clamp(
        tr_half * tr_half - (sxx * syy - sxy * sxy), min=0.0))
    return tr_half - det_part


def harris(image: torch.Tensor, radius: int = 2, kappa: float = 0.04,
           weighted: bool = False) -> torch.Tensor:
    """Harris corner response det - kappa tr^2 (HarrisCornerIntensity)."""
    sxx, sxy, syy = _structure_tensor(image, radius, weighted)
    tr = sxx + syy
    return (sxx * syy - sxy * sxy) - kappa * tr * tr


def kitros(image: torch.Tensor) -> torch.Tensor:
    """Kitchen-Rosenfeld corner intensity (KitRosCornerIntensity.java)."""
    dx, dy = _deriv.sobel(image)
    dxx, dyy, dxy = _deriv.hessian_from_gradient(dx, dy)
    num = dxx * dy * dy + dyy * dx * dx - 2.0 * dxy * dx * dy
    den = dx * dx + dy * dy
    return torch.where(den > 0, num / den, 0.0)


def hessian_det(image: torch.Tensor) -> torch.Tensor:
    """Hessian-determinant blob intensity
    (HessianBlobIntensity.DETERMINANT)."""
    dxx, dyy, dxy = _deriv.hessian_three(image)
    return dxx * dyy - dxy * dxy


def hessian_trace(image: torch.Tensor) -> torch.Tensor:
    """Laplacian-trace blob intensity (HessianBlobIntensity.TRACE)."""
    dxx, dyy, _ = _deriv.hessian_three(image)
    return torch.abs(dxx + dyy)


def median_intensity(image: torch.Tensor, radius: int = 2) -> torch.Tensor:
    """|I - median(I)| (MedianCornerIntensity.java)."""
    med = _blur.median(image.to(torch.float32), radius)
    return torch.abs(image - med)
