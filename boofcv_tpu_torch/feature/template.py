"""Template matching (port of ``boofcv_tpu/feature/template.py``).

Reference analog: boofcv-feature alg/feature/detect/template/
TemplateMatching.java with TemplateDiffSquared, TemplateSumAbsolute and
TemplateNCC.

The JAX package computes its correlations with ``lax.conv_general_dilated``
outside any TPU kernel; the port's :func:`_valid_correlate` is
``F.conv2d`` (cuDNN on the card), in float32 with both TF32 switches off
(``_config``), one launch where shifted adds take two a template pixel
(:func:`_valid_correlate_shifted`, the plain version it is timed beside).
SAD is th*tw shifted adds, as in the reference.  Peaks come from
``extract.detect`` (its nonmax tie ramp is the reference's).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from boofcv_tpu_torch._config import as_tensor
from boofcv_tpu_torch.feature import extract


def _valid_correlate(image: torch.Tensor,
                     kernel: torch.Tensor) -> torch.Tensor:
    """VALID cross-correlation of [H, W] with [th, tw]: [H-th+1, W-tw+1]."""
    return F.conv2d(image[None, None],
                    kernel.to(image.dtype)[None, None])[0, 0]


def _valid_correlate_shifted(image: torch.Tensor,
                             kernel: torch.Tensor) -> torch.Tensor:
    """:func:`_valid_correlate` as one shifted multiply-add a tap."""
    th, tw = kernel.shape
    oh, ow = image.shape[0] - th + 1, image.shape[1] - tw + 1
    acc = torch.zeros((oh, ow), dtype=image.dtype, device=image.device)
    for dy in range(th):
        for dx in range(tw):
            acc += image[dy:dy + oh, dx:dx + ow] * kernel[dy, dx]
    return acc


def _box_sum(image: torch.Tensor, th: int, tw: int) -> torch.Tensor:
    return _valid_correlate(image, torch.ones((th, tw), dtype=image.dtype,
                                              device=image.device))


def _pair(image, template, device):
    image = as_tensor(image, torch.float32, device)
    return image, as_tensor(template, torch.float32, image.device)


def match_ssd(image, template, device=None) -> torch.Tensor:
    """-SSD score map [H-th+1, W-tw+1] (higher is better):
    sum(I^2) - 2 corr(I, T) + sum(T^2)."""
    image, template = _pair(image, template, device)
    th, tw = template.shape
    corr = _valid_correlate(image, template)
    i2 = _box_sum(image * image, th, tw)
    t2 = torch.sum(template * template)
    return -(i2 - 2.0 * corr + t2)


def match_sad(image, template, device=None) -> torch.Tensor:
    """-SAD score map, exact by shift-accumulate (th*tw shifted adds)."""
    image, template = _pair(image, template, device)
    th, tw = template.shape
    h, w = image.shape
    oh, ow = h - th + 1, w - tw + 1
    acc = torch.zeros((oh, ow), dtype=torch.float32, device=image.device)
    for dy in range(th):
        for dx in range(tw):
            acc = acc + torch.abs(image[dy:dy + oh, dx:dx + ow]
                                  - template[dy, dx])
    return -acc


def match_ncc(image, template, eps: float = 1e-8,
              device=None) -> torch.Tensor:
    """Normalized cross-correlation score map in [-1, 1] (TemplateNCC)."""
    image, template = _pair(image, template, device)
    th, tw = template.shape
    n = th * tw
    tz = template - torch.mean(template)
    tnorm = torch.sqrt(torch.sum(tz * tz) + eps)
    corr = _valid_correlate(image, tz)
    isum = _box_sum(image, th, tw)
    i2sum = _box_sum(image * image, th, tw)
    inorm = torch.sqrt(torch.clamp(i2sum - isum * isum / n, min=eps))
    return corr / (inorm * tnorm)


def find_matches(score_map: torch.Tensor, max_matches: int = 5,
                 radius: int = 2,
                 threshold: float = float("-inf")) -> extract.Detections:
    """Top-N peaks of a score map (TemplateMatching.process); coordinates
    are the template's top-left corner."""
    return extract.detect(score_map, max_features=max_matches,
                          radius=radius, threshold=threshold)
