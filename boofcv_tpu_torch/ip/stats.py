"""Local image statistics & normalization (port of
``boofcv_tpu/ip/stats.py``, whole).

Reference analog: boofcv-ip alg/filter/stat/ImageLocalNormalization.java
(zero-mean/unit-variance windows) and alg/misc/ImageNormalization.java.
"""

from __future__ import annotations

import torch

from boofcv_tpu_torch.core.border import BorderType
from boofcv_tpu_torch.core.kernel import gaussian_kernel, mean_kernel
from boofcv_tpu_torch.ip import convolve


def local_mean_std(image: torch.Tensor, radius: int, gaussian: bool = False):
    """Windowed mean and stdev per pixel."""
    img = image.to(torch.float32)
    k = (gaussian_kernel(radius=radius, device=img.device) if gaussian
         else mean_kernel(radius, device=img.device))
    mean = convolve.separable(img, k, k, BorderType.NORMALIZED)
    mean2 = convolve.separable(img * img, k, k, BorderType.NORMALIZED)
    var = torch.clamp(mean2 - mean * mean, min=0.0)
    return mean, torch.sqrt(var)


def local_normalize(image: torch.Tensor, radius: int, delta: float = 1e-4,
                    gaussian: bool = True):
    """Zero-mean unit-variance local normalization
    (ImageLocalNormalization.zeroMeanStdOne)."""
    mean, std = local_mean_std(image, radius, gaussian)
    return (image.to(torch.float32) - mean) / (std + delta)


def normalize_minmax(image: torch.Tensor, out_min: float = 0.0,
                     out_max: float = 1.0):
    """Global min-max rescale (ImageNormalization)."""
    img = image.to(torch.float32)
    lo = torch.min(img)
    hi = torch.max(img)
    scale = (out_max - out_min) / torch.clamp(hi - lo, min=1e-12)
    return (img - lo) * scale + out_min


def normalize_zero_mean_unit_var(image: torch.Tensor):
    img = image.to(torch.float32)
    m = torch.mean(img)
    s = torch.std(img, correction=0)
    return (img - m) / torch.clamp(s, min=1e-12)
