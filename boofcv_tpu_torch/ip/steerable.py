"""Steerable Gaussian-derivative kernels and kernel math (port of
``boofcv_tpu/ip/steerable.py``).

Reference analog: boofcv-ip alg/filter/kernel/SteerableKernel.java,
FactorySteerable, KernelMath.java — an oriented derivative kernel as a
weighted sum of basis kernels.  Kernels are built in float64 on ``device``
(None: the card) and cast once.
"""

from __future__ import annotations

import math

import torch

from boofcv_tpu_torch._config import resolve_device
from boofcv_tpu_torch.core.kernel import (gaussian_deriv_kernel,
                                          gaussian_kernel)


def _second_deriv(sigma: float, radius: int, device) -> torch.Tensor:
    x = torch.arange(-radius, radius + 1, dtype=torch.float64,
                     device=device)
    g = torch.exp(-0.5 * (x / sigma) ** 2)
    k = (x * x / sigma ** 4 - 1.0 / sigma ** 2) * g
    return k - k.mean()


def _basis_1d(order: int, sigma: float, radius: int, device):
    if order == 1:
        return gaussian_deriv_kernel(sigma, radius, dtype=torch.float64,
                                     device=device)
    if order == 2:
        return _second_deriv(sigma, radius, device)
    return gaussian_kernel(sigma, radius, dtype=torch.float64, device=device)


def gaussian_basis_2d(order_x: int, order_y: int, sigma: float, radius: int,
                      device=None) -> torch.Tensor:
    """Separable Gaussian-derivative kernel G_{xy} of the given orders."""
    dev = resolve_device(device)
    kx = _basis_1d(order_x, sigma, radius, dev)
    ky = _basis_1d(order_y, sigma, radius, dev)
    return torch.outer(ky, kx).to(torch.float32)


def steer_first_derivative(angle: float, sigma: float, radius: int,
                           device=None) -> torch.Tensor:
    """G1 at an angle: cos(a) Gx + sin(a) Gy (SteerableKernel, order 1)."""
    gx = gaussian_basis_2d(1, 0, sigma, radius, device)
    gy = gaussian_basis_2d(0, 1, sigma, radius, device)
    return math.cos(angle) * gx + math.sin(angle) * gy


def steer_second_derivative(angle: float, sigma: float, radius: int,
                            device=None) -> torch.Tensor:
    """G2 at an angle: cos^2 Gxx + 2 cos sin Gxy + sin^2 Gyy."""
    gxx = gaussian_basis_2d(2, 0, sigma, radius, device)
    gyy = gaussian_basis_2d(0, 2, sigma, radius, device)
    gxy = gaussian_basis_2d(1, 1, sigma, radius, device)
    c, s = math.cos(angle), math.sin(angle)
    return c * c * gxx + 2 * c * s * gxy + s * s * gyy


# ------------------------- kernel math (KernelMath) -----------------------

def transpose(kernel2d: torch.Tensor) -> torch.Tensor:
    return torch.swapaxes(kernel2d, -1, -2)


def convolve_kernels_1d(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """1D kernel composition, the full convolution (KernelMath.convolve1D):
    one shifted multiply-add per tap of ``b``."""
    out = torch.zeros(a.shape[0] + b.shape[0] - 1,
                      dtype=torch.promote_types(a.dtype, b.dtype),
                      device=a.device)
    for j in range(b.shape[0]):
        out[j:j + a.shape[0]] += a * b[j]
    return out


def convolve_kernel_2d_from_1d(kx: torch.Tensor,
                               ky: torch.Tensor) -> torch.Tensor:
    return torch.outer(ky, kx)


def normalize_sum_to_one(kernel: torch.Tensor) -> torch.Tensor:
    s = torch.sum(kernel)
    return torch.where(s != 0, kernel / s, kernel)
