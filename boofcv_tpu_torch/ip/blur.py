"""Blur filters (port of ``boofcv_tpu/ip/blur.py``).

Reference analog: boofcv-ip alg/filter/blur/BlurImageOps.java.  Gaussian and
mean as separable convolutions; median as a sort over the window axis.
"""

from __future__ import annotations

import torch

from boofcv_tpu_torch.core.border import BorderType, pad
from boofcv_tpu_torch.core.kernel import gaussian_kernel, mean_kernel
from boofcv_tpu_torch.ip import convolve


def gaussian(image: torch.Tensor, sigma: float = -1.0, radius: int = -1,
             border: BorderType = BorderType.NORMALIZED) -> torch.Tensor:
    """Gaussian blur.  BlurImageOps.gaussian renormalizes at the edges."""
    dtype = image.dtype if image.is_floating_point() else torch.float32
    k = gaussian_kernel(sigma, radius, dtype=dtype, device=image.device)
    return convolve.separable(image.to(dtype), k, k, border)


def mean(image: torch.Tensor, radius: int,
         border: BorderType = BorderType.NORMALIZED) -> torch.Tensor:
    """Box blur (BlurImageOps.mean)."""
    k = mean_kernel(radius, dtype=torch.float32, device=image.device)
    return convolve.separable(image.to(torch.float32), k, k, border)


def median(image: torch.Tensor, radius: int) -> torch.Tensor:
    """Median filter (BlurImageOps.median) with EXTENDED border: the middle
    order statistic of each pixel's (2r+1)^2 window."""
    padded = pad(image, radius, radius, BorderType.EXTENDED)
    h, w = image.shape
    n = 2 * radius + 1
    windows = torch.stack(
        [padded[dy:dy + h, dx:dx + w] for dy in range(n) for dx in range(n)],
        dim=-1)                                          # [H, W, n*n]
    return torch.sort(windows, dim=-1).values[..., (n * n) // 2]
