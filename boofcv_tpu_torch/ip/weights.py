"""Spatial weight functions (port of ``boofcv_tpu/ip/weights.py``).

Reference analog: boofcv-ip alg/weights/ — WeightPixelGaussian_F32,
WeightPixelUniform_F32, WeightDistance_F32 / WeightDistanceSqGaussian_F32.
Weights are [2r+1, 2r+1] tensors multiplied into batched patch reductions.
"""

from __future__ import annotations

import torch

from boofcv_tpu_torch._config import resolve_device


def uniform_pixel(radius: int, dtype=torch.float32,
                  device=None) -> torch.Tensor:
    """WeightPixelUniform_F32: constant weight, sums to 1."""
    side = 2 * radius + 1
    return torch.full((side, side), 1.0 / (side * side), dtype=dtype,
                      device=resolve_device(device))


def gaussian_pixel(radius: int, sigma: float = -1.0, odd: bool = True,
                   dtype=torch.float32, normalize: bool = True,
                   device=None) -> torch.Tensor:
    """WeightPixelGaussian_F32: a sampled 2D Gaussian, computed in float64
    and cast once (normalized unless ``normalize=False``)."""
    if sigma <= 0:
        sigma = (radius * 2 + 1) / 6.0  # FactoryKernelGaussian sigmaForRadius
    xs = torch.arange(-radius, radius + 1, dtype=torch.float64,
                      device=resolve_device(device))
    g = torch.exp(-0.5 * (xs / sigma) ** 2)
    w = torch.outer(g, g)
    if normalize:
        w = w / torch.sum(w)
    return w.to(dtype)


def distance_sq_gaussian(dist_sq: torch.Tensor, sigma: float) -> torch.Tensor:
    """WeightDistanceSqGaussian_F32: weight from *squared* distance."""
    return torch.exp(-0.5 * dist_sq / (sigma * sigma)).to(torch.float32)


def distance_uniform(dist_sq: torch.Tensor, max_radius: float) -> torch.Tensor:
    """WeightDistanceUniform_F32: 1/r^2 inside the radius, else 0."""
    inv = 1.0 / (max_radius * max_radius)
    return torch.where(dist_sq <= max_radius * max_radius, inv, 0.0).to(
        torch.float32)
