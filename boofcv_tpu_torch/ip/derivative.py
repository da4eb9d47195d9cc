"""Image derivatives (port of ``boofcv_tpu/ip/derivative.py``, Sobel only).

BoofCV's GradientSobel convention: cross-correlation with [-1, 0, 1]
differentiation and [1, 2, 1] smoothing, EXTENDED border."""

from __future__ import annotations

import torch

from boofcv_tpu_torch.core.border import BorderType
from boofcv_tpu_torch.ip import convolve


def sobel(image: torch.Tensor, border: BorderType = BorderType.EXTENDED):
    """Sobel gradient (GradientSobel.java) of an [..., H, W] image.
    Returns (derivX, derivY).

    Shifted adds on the 1-pixel padded image (no TF32-capable conv)."""
    img = image.to(torch.float32)
    h, w = img.shape[-2:]
    p = convolve.pad_planes(img, 1, 1, border)

    def at(dy, dx):
        return p[..., 1 + dy:1 + dy + h, 1 + dx:1 + dx + w]

    dx = ((at(-1, 1) - at(-1, -1)) + 2.0 * (at(0, 1) - at(0, -1))
          + (at(1, 1) - at(1, -1)))
    dy = ((at(1, -1) - at(-1, -1)) + 2.0 * (at(1, 0) - at(-1, 0))
          + (at(1, 1) - at(-1, 1)))
    return dx, dy
