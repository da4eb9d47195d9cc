"""Sparse stereo block matching (port of ``boofcv_tpu/feature/disparity.py``:
``DisparityConfig`` and ``sparse_block_match``).

Reference analog: DisparitySparseScoreSadRect.java (sparse per-pixel SAD).

One SAD replaces the reference's TPU-only ``sad`` / ``sad_xla`` split (both
score identically).  The right strip and the left patch are read through
the window-gather kernel with ``2*ry+1`` rows starting at ``ys - ry``: the
kernel's row clamp reproduces the reference's per-row clip, and its column
clamp reads edge pixels that are then masked, so each out-of-image column
adds 1e6 per element as in the reference.

One stream ([h, w] images, [N] locations) or B streams ([B, h, w],
[B, N]): two launches of the kernel either way.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from boofcv_tpu_torch.kernels.window_gather import as_planes, gather_windows


class DisparityConfig(NamedTuple):
    """ConfigDisparityBM analog, the fields the VO's sparse matcher sets
    (the reference's per-pixel error bound stays off and its subpixel
    step on, as on the VO path)."""
    min_disparity: int = 0
    max_disparity: int = 64       # exclusive of min: range = max - min
    radius_x: int = 3
    radius_y: int = 3
    texture_threshold: float = 0.15     # <=0 disables


def _sparse_costs_sad(left, right, ys, xs, cfg: DisparityConfig):
    """[..., N, D] SAD cost table; cost index d scores disparity min + d."""
    w = left.shape[-1]
    rx, ry = cfg.radius_x, cfg.radius_y
    n_disp = cfg.max_disparity - cfg.min_disparity
    p = 2 * rx + 1
    ph = 2 * ry + 1
    wide_w = n_disp + 2 * rx                            # columns needed
    ys = ys.to(torch.int32)
    xs = xs.to(torch.int32)
    x0 = (xs - rx - (cfg.min_disparity + n_disp - 1)).contiguous()
    oy = (ys - ry).contiguous()
    strip = gather_windows(right, oy, x0, ph, wide_w)   # [N, PH, W']
    patch_l = gather_windows(left, oy, (xs - rx).contiguous(), ph, p)

    cols = x0[..., None] + torch.arange(wide_w, device=left.device)
    colb = (cols >= 0) & (cols < w)                     # [N, W']
    # window for disparity index d starts at strip column n_disp - 1 - d
    sl = strip.unfold(-1, p, 1).flip(-2)                # [N, PH, D, P]
    inb = colb.unfold(-1, p, 1).flip(-2)                # [N, D, P]
    e = torch.abs(patch_l[..., None, :] - sl).transpose(-3, -2)
    e = torch.where(inb[..., None, :], e, 1e6)          # [N, D, PH, P]
    return torch.sum(e, dim=(-2, -1))


def sparse_block_match(left: torch.Tensor, right: torch.Tensor,
                       ys: torch.Tensor, xs: torch.Tensor,
                       cfg: DisparityConfig = DisparityConfig()):
    """Sparse SAD block matching at N integer left-image locations.

    Returns (disp [..., N] f32, valid [..., N] bool): winner-take-all with
    the texture check and the subpixel parabola of the reference."""
    left = as_planes(left)
    right = as_planes(right)
    n_disp = cfg.max_disparity - cfg.min_disparity
    costs = _sparse_costs_sad(left, right, ys, xs, cfg)
    at = lambda d: torch.gather(costs, -1, d[..., None])[..., 0]
    best = torch.argmin(costs, dim=-1)
    cbest = at(best)
    valid = (xs - (cfg.min_disparity + best) >= 0) & (cbest < 1e17)
    if cfg.texture_threshold > 0:
        d_idx = torch.arange(n_disp, device=costs.device)
        near = torch.abs(d_idx - best[..., None]) <= 1
        c2 = torch.amin(torch.where(near, float("inf"), costs), dim=-1)
        valid &= (((c2 - cbest)
                   > cfg.texture_threshold * torch.clamp(cbest, min=1e-6))
                  | ~torch.isfinite(c2))

    # subpixel parabola through the best cost and its two neighbours
    dm = torch.clamp(best - 1, 0, n_disp - 1)
    dp = torch.clamp(best + 1, 0, n_disp - 1)
    cm = at(dm)
    cp = at(dp)
    denom = cm - 2.0 * cbest + cp
    off = torch.where(denom > 1e-9, 0.5 * (cm - cp) / denom, 0.0)
    interior = (best > 0) & (best < n_disp - 1)
    disp = best.to(torch.float32) + torch.where(
        interior, torch.clamp(off, -0.5, 0.5), 0.0)
    return disp + cfg.min_disparity, valid
