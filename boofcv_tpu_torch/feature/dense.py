"""Dense descriptors: HOG and dense SIFT grids (port of
``boofcv_tpu/feature/dense.py``).

Reference analog: boofcv-feature alg/feature/dense/ —
DescribeDenseHogAlg.java / DescribeDenseHogFastAlg (cell histograms and
block normalization) and DescribeDenseSiftAlg (SIFT on a regular grid).

HOG's cell histograms are a one-hot product summed over each cell, a fixed
order that repeats on the card.  Its gradient is a central difference by
``torch.roll``, so it wraps round the image border as the reference's
``jnp.roll`` does (ROADMAP queue 3: BoofCV's HOG gradient does not wrap).
"""

from __future__ import annotations

import math

import torch

from boofcv_tpu_torch._config import as_tensor
from boofcv_tpu_torch.feature import sift


def hog(image, cell_size: int = 8, block_cells: int = 2,
        num_bins: int = 9, signed: bool = False,
        device=None) -> torch.Tensor:
    """HOG descriptor grid: [BY, BX, block_cells^2 * num_bins] float64
    block descriptors, L2-normalized, BY = cells_y - block_cells + 1 and so
    on."""
    img = as_tensor(image, torch.float32, device)
    gy = torch.roll(img, -1, 0) - torch.roll(img, 1, 0)
    gx = torch.roll(img, -1, 1) - torch.roll(img, 1, 1)
    mag = torch.hypot(gx, gy)
    period = 2 * math.pi if signed else math.pi
    ang = torch.remainder(torch.arctan2(gy, gx), period)
    h, w = img.shape
    cy, cx = h // cell_size, w // cell_size
    mag = mag[: cy * cell_size, : cx * cell_size]
    ang = ang[: cy * cell_size, : cx * cell_size]
    # soft-assign each pixel to its two nearest orientation bins
    pos = ang / period * num_bins - 0.5
    b0 = torch.remainder(torch.floor(pos).to(torch.int64), num_bins)
    b1 = torch.remainder(b0 + 1, num_bins)
    f = pos - torch.floor(pos)
    # float64 votes, as the JAX package's float64 ``jnp.eye`` makes them
    eye = torch.eye(num_bins, dtype=torch.float64, device=img.device)
    votes = (eye[b0] * (mag * (1 - f))[..., None]
             + eye[b1] * (mag * f)[..., None])                  # [H, W, B]
    cells = votes.reshape(cy, cell_size, cx, cell_size,
                          num_bins).sum(dim=(1, 3))
    bc = block_cells
    by, bx = cy - bc + 1, cx - bc + 1
    blocks = torch.stack([cells[dy:dy + by, dx:dx + bx]
                          for dy in range(bc) for dx in range(bc)], dim=2)
    blocks = blocks.reshape(by, bx, bc * bc * num_bins)
    norm = torch.linalg.norm(blocks, dim=-1, keepdim=True) + 1e-6
    return blocks / norm


def dense_sift(image, cell: int = 8, step: int = 8, max_side: int = 64,
               device=None):
    """Upright SIFT descriptors on a regular grid (DescribeDenseSiftAlg):
    (ys [N], xs [N], descriptors [N, 128])."""
    img = as_tensor(image, torch.float32, device)
    h, w = img.shape
    margin = 2 * cell
    grid = lambda n: torch.arange(margin, n - margin, step,
                                  dtype=torch.float32, device=img.device)
    yy, xx = torch.meshgrid(grid(h), grid(w), indexing="ij")
    ys, xs = yy.reshape(-1), xx.reshape(-1)
    desc = sift.describe(img, ys, xs, torch.full_like(ys, 1.6),
                         torch.zeros_like(ys), width_sub=cell // 2)
    return ys, xs, desc
