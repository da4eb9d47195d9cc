"""Convolution-kernel construction (port of ``boofcv_tpu/core/kernel.py``).

Reference analog: boofcv-ip factory/filter/kernel/FactoryKernelGaussian.java
and struct/convolve/Kernel1D_*.java.  Kernels are plain tensors (odd length,
centred), computed in float64 and cast once.  The functions that make a
kernel from nothing take ``device`` (``None`` is the card) and compute it
there: a kernel copied up from the host would cost its caller a host sync.
"""

from __future__ import annotations

import math

import torch

from boofcv_tpu_torch._config import resolve_device


def gaussian_sigma_for_radius(radius: int, order: int = 0) -> float:
    """Default sigma for a radius (FactoryKernelGaussian.sigmaForRadius):
    sigma = (2r+1)/6, widened for the derivative order."""
    return (radius * 2 + 1) / 6.0 * (1.0 + order * 0.15)


def gaussian_radius_for_sigma(sigma: float, order: int = 0) -> int:
    """Inverse of :func:`gaussian_sigma_for_radius` (ceil): the order factor
    divides."""
    return int(math.ceil((6.0 * sigma / (1.0 + order * 0.15) - 1.0) / 2.0))


def _taps(radius: int, device) -> torch.Tensor:
    return torch.arange(-radius, radius + 1, dtype=torch.float64,
                        device=resolve_device(device))


def _gaussian64(sigma: float, radius: int, device) -> torch.Tensor:
    sigma, radius = _resolve(sigma, radius, order=0)
    k = torch.exp(-0.5 * (_taps(radius, device) / sigma) ** 2)
    return k / k.sum()


def gaussian_kernel(sigma: float = -1.0, radius: int = -1,
                    dtype=torch.float32, device=None) -> torch.Tensor:
    """1D normalized Gaussian kernel of length 2*radius+1.  Either sigma or
    radius may be unspecified (<= 0) and is derived from the other, as in
    FactoryKernelGaussian.gaussian1D."""
    return _gaussian64(sigma, radius, device).to(dtype)


def gaussian_deriv_kernel(sigma: float = -1.0, radius: int = -1,
                          dtype=torch.float32, device=None) -> torch.Tensor:
    """1D derivative-of-Gaussian kernel (FactoryKernelGaussian.derivativeI),
    normalized so that convolution with a unit ramp returns 1."""
    sigma, radius = _resolve(sigma, radius, order=1)
    x = _taps(radius, device)
    k = -x / (sigma ** 2) * torch.exp(-0.5 * (x / sigma) ** 2)
    resp = torch.sum(k * x)
    return torch.where(resp != 0, k / resp, k).to(dtype)


def gaussian_kernel_2d(sigma: float = -1.0, radius: int = -1,
                       dtype=torch.float32, device=None) -> torch.Tensor:
    k = _gaussian64(sigma, radius, device)
    k2 = torch.outer(k, k)
    return (k2 / k2.sum()).to(dtype)


def mean_kernel(radius: int, dtype=torch.float32,
                device=None) -> torch.Tensor:
    n = 2 * radius + 1
    return torch.full((n,), 1.0 / n, dtype=dtype,
                      device=resolve_device(device))


def normalize_kernel(kernel: torch.Tensor) -> torch.Tensor:
    s = torch.sum(kernel)
    return torch.where(s != 0, kernel / s, kernel)


def _resolve(sigma: float, radius: int, order: int) -> tuple[float, int]:
    if sigma <= 0 and radius <= 0:
        raise ValueError("either sigma or radius must be specified")
    if sigma <= 0:
        sigma = gaussian_sigma_for_radius(radius, order)
    elif radius <= 0:
        radius = gaussian_radius_for_sigma(sigma, order)
    return float(sigma), int(radius)
