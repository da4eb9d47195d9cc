"""Image enhancement (port of ``boofcv_tpu/ip/enhance.py``).

Reference analog: boofcv-ip alg/enhance/EnhanceImageOps.java — histogram
equalization (global and local-window), sharpen-4/8.

The global histogram is an integer ``scatter_add_``: its counts are exact
whatever order the card adds in, and unlike ``torch.bincount`` it reads
nothing back to the host.  ``equalize_local`` makes (2r+1)^2 shifted
compares, two launches each.
"""

from __future__ import annotations

import torch

from boofcv_tpu_torch.core.border import BorderType, pad
from boofcv_tpu_torch.ip import convolve


def equalize_histogram(image: torch.Tensor,
                       max_value: int = 255) -> torch.Tensor:
    """Global histogram equalization of an integer-valued image
    (EnhanceImageOps.equalize + applyTransform)."""
    n = max_value + 1
    idx = torch.clamp(torch.floor(image).to(torch.int64), 0, max_value)
    flat = idx.reshape(-1)
    hist = torch.zeros(n, dtype=torch.int64, device=image.device)
    hist.scatter_add_(0, flat, torch.ones_like(flat))
    cdf = torch.cumsum(hist, 0)
    total = cdf[-1]
    lut = torch.div(cdf * max_value, torch.clamp(total, min=1),
                    rounding_mode="floor")
    return lut[idx].to(image.dtype)


def equalize_local(image: torch.Tensor, radius: int,
                   max_value: int = 255) -> torch.Tensor:
    """Local histogram equalization (EnhanceImageOps.equalizeLocal) as a
    rank transform: (count of window pixels <= the centre) scaled, the
    local CDF at the centre pixel, over an EXTENDED border."""
    r = radius
    padded = pad(image, r, r, BorderType.EXTENDED)
    h, w = image.shape
    nwin = (2 * r + 1) ** 2
    count = torch.zeros((h, w), dtype=torch.int32, device=image.device)
    for dy in range(2 * r + 1):
        for dx in range(2 * r + 1):
            count += padded[dy:dy + h, dx:dx + w] <= image
    return torch.div(count * max_value, nwin,
                     rounding_mode="floor").to(image.dtype)


_SHARPEN4 = ((0.0, -1.0, 0.0), (-1.0, 5.0, -1.0), (0.0, -1.0, 0.0))
_SHARPEN8 = ((-1.0, -1.0, -1.0), (-1.0, 9.0, -1.0), (-1.0, -1.0, -1.0))


def _sharpen(image: torch.Tensor, taps, lo: float, hi: float):
    kernel = torch.tensor(taps, dtype=torch.float32, device=image.device)
    out = convolve.convolve2d(image.to(torch.float32), kernel,
                              BorderType.EXTENDED)
    return torch.clamp(out, lo, hi)


def sharpen4(image: torch.Tensor, lo: float = 0.0,
             hi: float = 255.0) -> torch.Tensor:
    return _sharpen(image, _SHARPEN4, lo, hi)


def sharpen8(image: torch.Tensor, lo: float = 0.0,
             hi: float = 255.0) -> torch.Tensor:
    return _sharpen(image, _SHARPEN8, lo, hi)
