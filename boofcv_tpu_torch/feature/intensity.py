"""Corner intensity (port of ``boofcv_tpu/feature/intensity.py``:
``_structure_tensor`` unweighted and ``shi_tomasi``).

Reference analog: ShiTomasiCornerIntensity.java over ImplSsdCorner's
structure tensor."""

from __future__ import annotations

import torch

from boofcv_tpu_torch.core.border import BorderType
from boofcv_tpu_torch.ip import convolve
from boofcv_tpu_torch.ip import derivative as _deriv


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


def _structure_tensor(image: torch.Tensor, radius: int = 2):
    """Unweighted sums of (dx^2, dxdy, dy^2) over a (2r+1) window
    (ImplSsdCorner)."""
    dx, dy = _deriv.sobel(image)
    return (_box_sum(dx * dx, radius), _box_sum(dx * dy, radius),
            _box_sum(dy * dy, radius))


def shi_tomasi(image: torch.Tensor, radius: int = 2) -> torch.Tensor:
    """Shi-Tomasi min-eigenvalue intensity (ShiTomasiCornerIntensity.java)
    of an [..., H, W] image."""
    sxx, sxy, syy = _structure_tensor(image, radius)
    tr_half = (sxx + syy) * 0.5
    det_part = torch.sqrt(torch.clamp(
        tr_half * tr_half - (sxx * syy - sxy * sxy), min=0.0))
    return tr_half - det_part
