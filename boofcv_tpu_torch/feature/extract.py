"""Non-maximum suppression + N-best selection (port of
``boofcv_tpu/feature/extract.py``: ``Detections``, ``nonmax_mask``,
``select_n_best``, ``detect``).

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
                threshold: float = 0.0, border: int = 0) -> torch.Tensor:
    """Boolean local-maximum mask (NonMaxBlock strict semantics): equal to
    the window max and above threshold, plateau ties broken by raster order
    through the reference's epsilon ramp."""
    h, w = intensity.shape[-2:]
    wmax = _window_max(intensity, radius)
    mask = (intensity >= wmax) & (intensity > threshold)
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
