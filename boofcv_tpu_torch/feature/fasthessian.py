"""SURF Fast-Hessian detector on the integral image (port of
``boofcv_tpu/feature/fasthessian.py``).

Reference analog: boofcv-feature alg/feature/detect/interest/
FastHessianFeatureDetector.java — Hessian-determinant blob responses from
box filters over the integral image at a ladder of filter sizes, 3x3x3
scale-space nonmax, quadratic subpixel refinement.

The responses of an octave are stacked on a leading axis, nonmax is a max
pool over the stack, detections are a top-k.  ``torch.topk`` orders ties
differently from ``lax.top_k``: the two packages agree on detections as
sets.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from boofcv_tpu_torch.feature.extract import _window_max
from boofcv_tpu_torch.ip import integral as ii_ops


class ScaleDetections(NamedTuple):
    ys: torch.Tensor      # [N] f32 (subpixel)
    xs: torch.Tensor      # [N] f32
    scales: torch.Tensor  # [N] f32 (SURF scale = 1.2 * size / 9)
    scores: torch.Tensor  # [N]
    valid: torch.Tensor   # [N] bool


def hessian_response(ii: torch.Tensor, size: int) -> torch.Tensor:
    """Hessian-determinant response image for one box-filter size (full
    resolution): det = Dxx*Dyy - (0.9*Dxy)^2, each normalized by the filter
    area; -inf on the rim where the filter sticks out."""
    h, w = ii.shape
    norm = 1.0 / (size * size)
    dxx = ii_ops.deriv_xx_grid(ii, size) * norm
    dyy = ii_ops.deriv_yy_grid(ii, size) * norm
    dxy = ii_ops.deriv_xy_grid(ii, size) * norm
    det = dxx * dyy - (0.9 * dxy) ** 2
    r = size // 2 + 1
    out = torch.full_like(det, float("-inf"))
    out[r:h - r, r:w - r] = det[r:h - r, r:w - r]
    return out


def detect(ii: torch.Tensor, max_features: int,
           sizes: Sequence[int] = (9, 15, 21, 27),
           nonmax_radius: int = 1, threshold: float = 0.0) -> ScaleDetections:
    """Single-octave scale-space detection (detectOctave).

    The reference ladders sizes per octave {9,15,21,27}, {15,27,39,51}, ...
    Call this per octave and merge, or use :func:`detect_multi_octave`."""
    stack = torch.stack([hessian_response(ii, s) for s in sizes])  # [S, H, W]
    n_s, h, w = stack.shape
    # 3x3x3 nonmax: max over the spatial window, then over the scale triplet
    wmax = _window_max(stack, nonmax_radius)
    neigh_max = torch.stack([
        torch.amax(wmax[max(0, i - 1):min(n_s, i + 2)], dim=0)
        for i in range(n_s)])
    is_peak = (stack >= neigh_max) & (stack > threshold)
    # only interior scales can be scale-space maxima (the reference skips
    # the ends)
    is_peak[0] = False
    is_peak[-1] = False

    flat = torch.where(is_peak, stack, float("-inf")).reshape(-1)
    scores, idx = torch.topk(flat, max_features)
    valid = torch.isfinite(scores)
    si = idx // (h * w)
    rem = idx % (h * w)
    yi = rem // w
    xi = rem % w
    ys = yi.to(torch.float32)
    xs = xi.to(torch.float32)

    # quadratic subpixel in x, y and scale (FastHessian interpolation)
    def center_val(s, y, x):
        return stack[torch.clamp(s, 0, n_s - 1), torch.clamp(y, 1, h - 2),
                     torch.clamp(x, 1, w - 2)]

    v = center_val(si, yi, xi)
    dx = (center_val(si, yi, xi + 1) - center_val(si, yi, xi - 1)) * 0.5
    dy = (center_val(si, yi + 1, xi) - center_val(si, yi - 1, xi)) * 0.5
    dxx = center_val(si, yi, xi + 1) - 2 * v + center_val(si, yi, xi - 1)
    dyy = center_val(si, yi + 1, xi) - 2 * v + center_val(si, yi - 1, xi)
    # peaks beside the -inf rim give non-finite derivatives (inf - inf);
    # the reference skips subpixel there: offset 0
    safe_div = lambda num, den: torch.nan_to_num(
        torch.where(den != 0, -num / den, 0.0), nan=0.0, posinf=0.0,
        neginf=0.0)
    ox = torch.clamp(safe_div(dx, dxx), -0.5, 0.5)
    oy = torch.clamp(safe_div(dy, dyy), -0.5, 0.5)

    ds_ = (center_val(si + 1, yi, xi) - center_val(si - 1, yi, xi)) * 0.5
    dss = center_val(si + 1, yi, xi) - 2 * v + center_val(si - 1, yi, xi)
    os_ = torch.clamp(safe_div(ds_, dss), -0.5, 0.5)
    size_at = torch.zeros_like(v)        # sizes[si], without a host copy
    for i, s in enumerate(sizes):
        size_at = torch.where(si == i, float(s), size_at)
    size_step = float(sizes[1] - sizes[0]) if n_s > 1 else 6.0
    size_interp = size_at + os_ * size_step
    scale = 1.2 * size_interp / 9.0

    safe = lambda a: torch.where(valid, a, 0.0)
    return ScaleDetections(safe(ys + oy), safe(xs + ox), safe(scale),
                           safe(scores), valid)


def detect_multi_octave(ii: torch.Tensor, max_features_per_octave: int,
                        num_octaves: int = 3) -> ScaleDetections:
    """Reference-style octave ladder {9,15,21,27}, {15,27,39,51},
    {27,51,75,99}: each octave's first size is the previous octave's
    second."""
    octaves = []
    for o in range(num_octaves):
        step = 6 * (2 ** o)
        sizes = tuple(step + 3 + i * step for i in range(4))
        octaves.append(detect(ii, max_features_per_octave, sizes))
    return ScaleDetections(*(torch.cat(field) for field in zip(*octaves)))
