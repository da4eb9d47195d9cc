"""Keypoint orientation estimators (port of
``boofcv_tpu/feature/orientation.py``).

Reference analog: boofcv-feature alg/feature/orientation/ —
OrientationAverage (weighted mean gradient), OrientationHistogram,
OrientationSlidingWindow.  The integral-image Haar variant SURF uses is
``feature/describe.orientation_average_haar``.

All estimators are batched over N keypoints: one gather of the gradient
patches, then reductions.
"""

from __future__ import annotations

import numpy as np
import torch

from boofcv_tpu_torch.ip.interpolate import sample_rect_bilinear


def _grad_patches(image, ys, xs, radius):
    img = image.to(torch.float32)
    gx_img = torch.roll(img, -1, 1) - torch.roll(img, 1, 1)
    gy_img = torch.roll(img, -1, 0) - torch.roll(img, 1, 0)
    gx = sample_rect_bilinear(gx_img, ys, xs, radius)
    gy = sample_rect_bilinear(gy_img, ys, xs, radius)
    return gx, gy


def average(image, ys, xs, radius: int = 6, weighted: bool = True):
    """Weighted average-gradient angle (OrientationAverage)."""
    gx, gy = _grad_patches(image, ys, xs, radius)
    if weighted:
        d = torch.arange(-radius, radius + 1, dtype=torch.float32,
                         device=gx.device)
        w = torch.exp(-0.5 * (d[:, None] ** 2 + d[None, :] ** 2)
                      / (radius / 2.0) ** 2)
        gx = gx * w
        gy = gy * w
    return torch.atan2(torch.sum(gy, dim=(1, 2)), torch.sum(gx, dim=(1, 2)))


def histogram(image, ys, xs, radius: int = 6, num_bins: int = 36):
    """Dominant histogram-bin angle (OrientationHistogram).  The bins
    accumulate in float64, as the reference's do."""
    gx, gy = _grad_patches(image, ys, xs, radius)
    mag = torch.hypot(gx, gy)
    ang = torch.remainder(torch.atan2(gy, gx), 2 * np.pi)
    bins = torch.clamp((ang / (2 * np.pi) * num_bins).to(torch.int64),
                       0, num_bins - 1)
    n = ys.shape[0]
    hist = torch.zeros((n, num_bins), dtype=torch.float64,
                       device=mag.device).scatter_add_(
        1, bins.reshape(n, -1), mag.reshape(n, -1).to(torch.float64))
    best = torch.argmax(hist, dim=1)
    return (best.to(torch.float32) + 0.5) * (2 * np.pi / num_bins)


def sliding_window(image, ys, xs, radius: int = 6,
                   window: float = np.pi / 3, num_steps: int = 32):
    """Angle of the window that maximizes the summed gradient magnitude
    (OrientationSlidingWindow).  The window centres are float64, as the
    reference's are, so membership is decided in float64."""
    gx, gy = _grad_patches(image, ys, xs, radius)
    n = ys.shape[0]
    mag = torch.hypot(gx, gy).reshape(n, -1)
    ang = torch.atan2(gy, gx).reshape(n, -1)
    centers = -np.pi + torch.arange(
        num_steps, dtype=torch.float64, device=ang.device) * (2 * np.pi
                                                              / num_steps)
    diff = torch.abs(torch.remainder(
        (ang[:, None, :] - centers[None, :, None]) + np.pi, 2 * np.pi)
        - np.pi)
    inside = diff <= window / 2
    sx = torch.sum(torch.where(inside, (mag * torch.cos(ang))[:, None, :],
                               0.0), -1)
    sy = torch.sum(torch.where(inside, (mag * torch.sin(ang))[:, None, :],
                               0.0), -1)
    best = torch.argmax(sx * sx + sy * sy, dim=1, keepdim=True)
    return torch.atan2(torch.gather(sy, 1, best)[:, 0],
                       torch.gather(sx, 1, best)[:, 0])
