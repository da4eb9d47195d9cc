"""Non-maximum suppression + N-best selection (port of
``boofcv_tpu/feature/extract.py``: ``Detections``, ``nonmax_mask``,
``select_n_best``, ``detect``, ``subpixel_quadratic``, ``detect_tracks``).

Reference analog: NonMaxBlock.java (strict), SelectNBestFeatures.java.
``torch.topk`` orders ties differently from ``lax.top_k``, so the two
packages agree on detections as sets, not as sequences.

Every function takes an [H, W] intensity image or a [B, H, W] stack of
streams; each stream is detected on its own (its own tie ramp, its own
top-k).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from boofcv_tpu_torch.feature import intensity


class Detections(NamedTuple):
    """Fixed-capacity feature set (QueueCorner + intensity analog)."""
    ys: torch.Tensor      # [..., N] int32
    xs: torch.Tensor      # [..., N] int32
    scores: torch.Tensor  # [..., N] f32
    valid: torch.Tensor   # [..., N] bool


def _window_max(intensity: torch.Tensor, radius: int) -> torch.Tensor:
    """Max over the (2r+1)^2 neighbourhood, out-of-image taps ignored."""
    n = 2 * radius + 1
    h, w = intensity.shape[-2:]
    return F.max_pool2d(intensity.reshape(-1, 1, h, w), n, stride=1,
                        padding=radius).reshape(intensity.shape)


def nonmax_mask(intensity: torch.Tensor, radius: int = 2,
                threshold: float = 0.0, border: int = 0,
                strict: bool = True) -> torch.Tensor:
    """Boolean local-maximum mask: equal to the window max and above
    threshold.  ``strict`` (NonMaxBlock's strict semantics) breaks plateau
    ties by raster order through the reference's epsilon ramp, which also
    drops a peak whose raster-earlier neighbour is within the ramp's
    epsilon of it; ``strict=False`` keeps every pixel equal to its window
    max."""
    h, w = intensity.shape[-2:]
    wmax = _window_max(intensity, radius)
    mask = (intensity >= wmax) & (intensity > threshold)
    if strict:
        ramp = torch.arange(h * w, dtype=torch.float32,
                            device=intensity.device).reshape(h, w)
        eps = torch.finfo(torch.float32).eps
        tie = intensity - ramp * eps * torch.clamp(intensity.abs(), min=1.0)
        mask = mask & (tie >= _window_max(tie, radius))
    if border > 0:
        edge = torch.zeros((h, w), dtype=torch.bool, device=mask.device)
        edge[border:h - border, border:w - border] = True
        mask = mask & edge
    return mask


def select_n_best(intensity: torch.Tensor, mask: torch.Tensor,
                  max_features: int) -> Detections:
    """Top-k detections from a masked intensity image (SelectNBestFeatures)."""
    h, w = intensity.shape[-2:]
    flat = torch.where(mask, intensity, float("-inf")).reshape(
        intensity.shape[:-2] + (h * w,))
    scores, idx = torch.topk(flat, max_features, dim=-1)
    valid = torch.isfinite(scores)
    ys = (idx // w).to(torch.int32)
    xs = (idx % w).to(torch.int32)
    zero = torch.zeros_like(ys)
    return Detections(torch.where(valid, ys, zero), torch.where(valid, xs, zero),
                      torch.where(valid, scores, 0.0), valid)


def detect(intensity: torch.Tensor, max_features: int, radius: int = 2,
           threshold: float = 0.0, border: int = 0) -> Detections:
    """intensity -> nonmax -> top-k (GeneralFeatureDetector.process:107)."""
    mask = nonmax_mask(intensity, radius, threshold, border)
    return select_n_best(intensity, mask, max_features)


def subpixel_quadratic(intensity: torch.Tensor, det: Detections) -> tuple:
    """Quadratic peak interpolation around each detection, separately in x
    and y (the reference's polynomial subpixel step for SURF and SIFT).
    Detections are clamped one pixel inside an [H, W] image and the offsets
    to +-0.5.  Returns float32 (ys, xs)."""
    h, w = intensity.shape
    yc = torch.clamp(det.ys.long(), 1, h - 2)
    xc = torch.clamp(det.xs.long(), 1, w - 2)
    at = lambda dy, dx: intensity[yc + dy, xc + dx]
    c, l, r, u, d = at(0, 0), at(0, -1), at(0, 1), at(-1, 0), at(1, 0)
    dx_ = (r - l) * 0.5
    dy_ = (d - u) * 0.5
    dxx = r - 2 * c + l
    dyy = d - 2 * c + u
    ox = torch.where(dxx != 0, -dx_ / dxx, 0.0).clamp(-0.5, 0.5)
    oy = torch.where(dyy != 0, -dy_ / dyy, 0.0).clamp(-0.5, 0.5)
    return (yc + oy).to(torch.float32), (xc + ox).to(torch.float32)


def detect_tracks(image: torch.Tensor, max_features: int, radius: int = 6,
                  threshold: float = 1.0, border: int = 12,
                  shi_tomasi_radius: int = 2) -> tuple:
    """Shi-Tomasi corners to seed KLT tracks: the shared recipe of
    ``sfm/stitch2d``, ``sfm/mono_plane_vo`` and ``sfm/overhead_vo``.
    Returns (ys [N] f32, xs [N] f32, valid [N])."""
    inten = intensity.shi_tomasi(image, radius=shi_tomasi_radius)
    det = detect(inten, max_features=max_features, radius=radius,
                 threshold=threshold, border=border)
    return det.ys.to(torch.float32), det.xs.to(torch.float32), det.valid


def near_live(cand_x, cand_y, xs, ys, alive, radius: int) -> torch.Tensor:
    """[..., M] candidates within 2 ``radius`` of a live track: the spawns'
    rejection of corners that would duplicate a track."""
    d2 = ((cand_x[..., :, None] - xs[..., None, :]) ** 2
          + (cand_y[..., :, None] - ys[..., None, :]) ** 2)
    d2 = torch.where(alive[..., None, :], d2, float("inf"))
    return torch.amin(d2, dim=-1) <= (2 * radius) ** 2
