"""Feature descriptors: SURF-64, BRIEF, NCC template (port of
``boofcv_tpu/feature/describe.py``).

Reference analog: boofcv-feature alg/feature/describe/DescribePointSurf.java
(4x4 grid x 5x5 samples of Haar dx, dy -> 64-D), DescribePointBrief.java
(random-pair binary), DescribePointPixelRegionNCC.java, and the SURF
orientation of alg/feature/orientation/*.

Every descriptor is one batched gather and reduction over all N keypoints;
BRIEF packs its bits with shifts.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from boofcv_tpu_torch._config import resolve_device
from boofcv_tpu_torch.ip import integral as ii_ops
from boofcv_tpu_torch.ip.interpolate import bilinear, sample_rect_bilinear


# ---------------- orientation (SURF average-gradient style) -------------

def orientation_average_haar(ii: torch.Tensor, ys, xs, scales,
                             radius: int = 6) -> torch.Tensor:
    """Average Haar-response orientation inside a radius-6s disc
    (OrientationAverageIntegral analog).  Returns the angle [N] in radians.
    The whole (2r+1)^2 square of offsets is evaluated at once as [M, N];
    the offsets outside the disc weigh 0."""
    d = torch.arange(-radius, radius + 1, dtype=torch.float32,
                     device=ii.device)
    dy, dx = (g.reshape(-1, 1) for g in torch.meshgrid(d, d, indexing="ij"))
    d2 = dy * dy + dx * dx
    w = torch.where(d2 <= radius * radius,
                    torch.exp(-0.5 * d2 / (radius * radius / 4.0)), 0.0)
    py = torch.round(ys + dy * scales).to(torch.int32)
    px = torch.round(xs + dx * scales).to(torch.int32)
    r = torch.clamp(torch.round(2 * scales).to(torch.int32), min=1)
    gx = ii_ops.haar_x(ii, py, px, r)
    gy = ii_ops.haar_y(ii, py, px, r)
    return torch.atan2(torch.sum(gy * w, dim=0), torch.sum(gx * w, dim=0))


# ---------------- SURF-64 ------------------------------------------------

def surf(ii: torch.Tensor, ys, xs, scales, angles=None,
         widthLargeGrid: int = 4, widthSubRegion: int = 5) -> torch.Tensor:
    """SURF-64 descriptor for N keypoints (DescribePointSurf.describe).

    4x4 subregions x 5x5 samples; per sample the Haar dx, dy (rotated),
    Gaussian-weighted; per subregion (sum dx, sum |dx|, sum dy, sum |dy|);
    the 64-vector L2-normalized.  angles=None => upright (U-SURF)."""
    n = ys.shape[0]
    dev = ii.device
    side = widthLargeGrid * widthSubRegion
    half = side // 2                                  # 10 sample units
    # sample lattice in the keypoint frame, centred
    u = torch.arange(side, dtype=torch.float32, device=dev) - half + 0.5
    uu, vv = (g.reshape(-1) for g in torch.meshgrid(u, u, indexing="ij"))

    if angles is None:
        ca = torch.ones_like(ys)
        sa = torch.zeros_like(ys)
    else:
        ca = torch.cos(angles)
        sa = torch.sin(angles)

    s = scales.to(torch.float32)
    # image offsets of each sample: rotate the lattice, scale
    ox = (ca[:, None] * uu[None, :] - sa[:, None] * vv[None, :]) * s[:, None]
    oy = (sa[:, None] * uu[None, :] + ca[:, None] * vv[None, :]) * s[:, None]
    py = torch.round(ys[:, None] + oy).to(torch.int32)            # [N, M]
    px = torch.round(xs[:, None] + ox).to(torch.int32)

    r = torch.clamp(torch.round(s).to(torch.int32), min=1)[:, None]
    gx = ii_ops.haar_x(ii, py, px, r)                             # [N, M]
    gy = ii_ops.haar_y(ii, py, px, r)
    # rotate the gradients into the keypoint frame
    rgx = ca[:, None] * gx + sa[:, None] * gy
    rgy = -sa[:, None] * gx + ca[:, None] * gy

    # Gaussian weight over the whole grid
    sigma = half * 0.84
    wgt = torch.exp(-0.5 * (uu ** 2 + vv ** 2) / (sigma * sigma))[None, :]
    rgx = rgx * wgt
    rgy = rgy * wgt

    # accumulate into the 4x4 cells: sample (i, j) lies in cell
    # (i // 5, j // 5)
    g, sub = widthLargeGrid, widthSubRegion
    cells = lambda a: a.reshape(n, g, sub, g, sub).sum(dim=(2, 4)).reshape(
        n, g * g)
    desc = torch.stack([cells(rgx), cells(rgx.abs()), cells(rgy),
                        cells(rgy.abs())], dim=-1).reshape(n, g * g * 4)
    norm = torch.linalg.vector_norm(desc, dim=1, keepdim=True)
    return desc / torch.clamp(norm, min=1e-12)


# ---------------- BRIEF --------------------------------------------------

class BriefDefinition(NamedTuple):
    """Random point pairs (DescribePointBrief's BinaryCompareDefinition)."""
    ay: torch.Tensor  # [B]
    ax: torch.Tensor
    by: torch.Tensor
    bx: torch.Tensor


def brief_definition(num_bits: int = 512, radius: int = 16,
                     seed: int = 9898, device=None) -> BriefDefinition:
    """Gaussian-sampled pairs inside the patch (FactoryDescribePointAlgs
    .brief defaults: 512 bits, radius 16, gaussian sigma r/2), drawn on the
    host from ``seed``; ``device`` None is the card."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    pts = np.clip(rng.normal(0, radius / 2.0, size=(num_bits, 4)),
                  -radius, radius)
    return BriefDefinition(*(torch.from_numpy(pts[:, i]).to(
        device=dev, dtype=torch.float32) for i in range(4)))


def brief(image_blurred: torch.Tensor, ys, xs,
          definition: BriefDefinition) -> torch.Tensor:
    """BRIEF binary descriptor, packed into int32 words [N, B/32] (bit k of
    a word is comparison 32*word + k; bit 31 is the sign bit).

    The reference blurs with a Gaussian first (DescribePointBrief takes a
    blurred image); pass that in."""
    ys = ys.to(torch.float32)
    xs = xs.to(torch.float32)
    va = bilinear(image_blurred, ys[:, None] + definition.ay[None, :],
                  xs[:, None] + definition.ax[None, :])
    vb = bilinear(image_blurred, ys[:, None] + definition.by[None, :],
                  xs[:, None] + definition.bx[None, :])
    bits = (va < vb).to(torch.int32)                  # [N, B]
    n, b = bits.shape
    words = bits.reshape(n, b // 32, 32)
    shifts = torch.arange(32, dtype=torch.int32, device=bits.device)
    # at most one term is negative (bit 31), so no partial sum leaves int32
    return torch.sum(words << shifts, dim=-1, dtype=torch.int32)


# ---------------- NCC template -------------------------------------------

def ncc_template(image: torch.Tensor, ys, xs, radius: int = 5) -> torch.Tensor:
    """Zero-mean unit-variance patch descriptor [N, (2r+1)^2]
    (DescribePointPixelRegionNCC analog)."""
    patches = sample_rect_bilinear(image, ys.to(torch.float32),
                                   xs.to(torch.float32), radius)
    flat = patches.reshape(patches.shape[0], -1)
    mu = torch.mean(flat, dim=1, keepdim=True)
    sd = torch.std(flat, dim=1, keepdim=True, unbiased=False)
    return (flat - mu) / torch.clamp(sd, min=1e-8)
