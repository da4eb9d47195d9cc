"""Batched pyramidal KLT tracker (port of ``boofcv_tpu/feature/klt.py``).

Reference analog: boofcv-feature alg/tracker/klt/KltTracker.java:55
(inverse-compositional translation-only KLT), PyramidKltTracker.java:37
(coarse-to-fine), KltTrackFault.java (fault codes).

Only the ``"windowed"`` level method is ported: each level gathers every
track's 24x16 neighbourhood once, then each Gauss-Newton iteration
resamples the patch inside that window.

:func:`track_pyramid` dispatches by device, never by failure.  CUDA
tensors go to one launch of ``kernels/csrc/klt_track.cu``, which keeps each
track's window in shared memory and runs every level's iterations there.
CPU tensors take :func:`track_pyramid_reference`, the plain PyTorch version
of the same function: it gathers the windows through
``kernels.window_gather`` and turns the reference's early-exit
``while_loop`` into a fixed ``max_iterations`` loop with a per-track frozen
flag (converged tracks already take zero steps there, so the results are
the same).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Sequence, Tuple

import torch

from boofcv_tpu_torch.ip.interpolate import sample_rect_bilinear_multi
from boofcv_tpu_torch.kernels.klt_track import klt_track_cuda
from boofcv_tpu_torch.kernels.window_gather import (aligned_window_origin,
                                                    gather_windows)

# Fault codes (KltTrackFault analog)
TRACK_OK = 0
FAULT_OUT_OF_BOUNDS = 1
FAULT_FAILED = 2          # singular Gauss-Newton system
FAULT_DRIFTED = 3         # did not converge
FAULT_LARGE_ERROR = 4     # per-pixel SAD error above maxPerPixelError


@dataclass(frozen=True)
class KltConfig:
    """PkltConfig analog."""
    template_radius: int = 3
    max_iterations: int = 8
    max_per_pixel_error: float = 25.0
    min_determinant: float = 0.001
    convergence_tol: float = 0.01  # pixels at the level's scale
    method: str = "windowed"


class KltTemplates(NamedTuple):
    """Per-track templates at every pyramid level: desc[level] is
    [N, P, P], grad_x / grad_y likewise."""
    desc: Tuple[torch.Tensor, ...]
    grad_x: Tuple[torch.Tensor, ...]
    grad_y: Tuple[torch.Tensor, ...]


def sample_templates(pyramid: Sequence[torch.Tensor],
                     grads: Tuple[Sequence[torch.Tensor],
                                  Sequence[torch.Tensor]],
                     ys: torch.Tensor, xs: torch.Tensor,
                     scales: Sequence[int], radius: int) -> KltTemplates:
    """Template + gradient patches at every level for N features at
    level-0 float coordinates (ys, xs)."""
    dxs, dys = grads
    desc, gx, gy = [], [], []
    for lvl, s in enumerate(scales):
        stack = torch.stack([pyramid[lvl], dxs[lvl], dys[lvl]])
        d, g1, g2 = sample_rect_bilinear_multi(stack, ys / s, xs / s, radius)
        desc.append(d)
        gx.append(g1)
        gy.append(g2)
    return KltTemplates(tuple(desc), tuple(gx), tuple(gy))


def _resample(win: torch.Tensor, py: torch.Tensor, px: torch.Tensor,
              p: int, margin_y: float, margin_x: float) -> torch.Tensor:
    """[N, P, P] patch at in-window top-left (py, px): x interpolation of
    the P+1 rows the patch needs, then y interpolation: the two nonzero
    taps per row of the reference's one-hot Wy @ (window @ Wx^T)
    (``_interp_matrix``), taken directly."""
    n = win.shape[0]
    py = torch.clamp(py, 0.0, margin_y)
    px = torch.clamp(px, 0.0, margin_x)
    by = torch.floor(py)
    bx = torch.floor(px)
    fy = (py - by)[:, None, None]
    fx = (px - bx)[:, None, None]
    k = torch.arange(p + 1, device=win.device)
    rows = (by.long()[:, None] + k[None, :])[:, :, None].expand(
        n, p + 1, win.shape[2])
    band = win.gather(1, rows)                                 # [N, P+1, WX]
    cols = (bx.long()[:, None] + k[None, :p])[:, None, :].expand(n, p + 1, p)
    t = (1 - fx) * band.gather(2, cols) + fx * band.gather(2, cols + 1)
    return (1 - fy) * t[:, :p] + fy * t[:, 1:]


def _track_level_windowed(image, desc, gx, gy, cy, cx, cfg: KltConfig):
    """One KLT level for all N tracks: one window gather, then a fixed
    count of Gauss-Newton steps inside the windows.  Tracks whose motion
    reaches the window edge clamp there and fault out-of-bounds."""
    n = desc.shape[0]
    r = cfg.template_radius
    p = 2 * r + 1
    wy_sz = 24 if p + 2 <= 16 else 32
    wx_sz = 16 if p + 2 <= 16 else 32
    h, w = image.shape
    img = image.to(torch.float32).contiguous()
    dt = torch.float32

    gxx = torch.sum(gx * gx, dim=(1, 2))
    gxy = torch.sum(gx * gy, dim=(1, 2))
    gyy = torch.sum(gy * gy, dim=(1, 2))
    det = gxx * gyy - gxy * gxy
    ok_det = det / (p * p) >= cfg.min_determinant
    safe_det = torch.where(det == 0, 1.0, det)

    cy = cy.to(dt)
    cx = cx.to(dt)
    oy, ox, py, px = aligned_window_origin(cy, cx, r, h, w, wy_sz, wx_sz)
    win = gather_windows(img, oy.contiguous(), ox.contiguous(), wy_sz, wx_sz)

    margin_y = float(wy_sz - p - 1)
    margin_x = float(wx_sz - p - 1)
    done = torch.zeros((n,), dtype=torch.bool, device=img.device)
    per_pixel = torch.zeros((n,), dtype=dt, device=img.device)
    for _ in range(cfg.max_iterations):
        err = _resample(win, py, px, p, margin_y, margin_x) - desc
        per_pixel = torch.mean(torch.abs(err), dim=(1, 2))
        bx_ = torch.sum(err * gx, dim=(1, 2))
        by_ = torch.sum(err * gy, dim=(1, 2))
        dx = (gyy * bx_ - gxy * by_) / safe_det
        dy = (gxx * by_ - gxy * bx_) / safe_det
        py = py - torch.where(done, 0.0, dy)
        px = px - torch.where(done, 0.0, dx)
        done = done | ((torch.abs(dx) < cfg.convergence_tol)
                       & (torch.abs(dy) < cfg.convergence_tol))

    cy_out = torch.clamp(py, 0.0, margin_y) + r + oy.to(dt)
    cx_out = torch.clamp(px, 0.0, margin_x) + r + ox.to(dt)
    in_bounds = ((cy_out >= r) & (cy_out <= h - 1 - r)
                 & (cx_out >= r) & (cx_out <= w - 1 - r)
                 & (py > 0) & (py < margin_y) & (px > 0) & (px < margin_x))
    fault = torch.full((n,), TRACK_OK, dtype=torch.int32, device=img.device)
    fault = torch.where(per_pixel > cfg.max_per_pixel_error,
                        FAULT_LARGE_ERROR, fault)
    fault = torch.where(~ok_det, FAULT_FAILED, fault)
    fault = torch.where(~in_bounds, FAULT_OUT_OF_BOUNDS, fault)
    return cy_out, cx_out, fault


def track_pyramid_reference(pyramid: Sequence[torch.Tensor],
                            templates: KltTemplates, ys: torch.Tensor,
                            xs: torch.Tensor, scales: Sequence[int],
                            cfg: KltConfig):
    """The plain PyTorch version of :func:`track_pyramid` (windowed
    method), level by level, on whatever device the tensors lie."""
    n = ys.shape[0]
    fault = torch.full((n,), TRACK_OK, dtype=torch.int32, device=ys.device)
    cy = ys / scales[-1]
    cx = xs / scales[-1]
    for lvl in range(len(scales) - 1, -1, -1):
        cy_l, cx_l, f = _track_level_windowed(
            pyramid[lvl], templates.desc[lvl], templates.grad_x[lvl],
            templates.grad_y[lvl], cy, cx, cfg)
        good = f == TRACK_OK
        cy = torch.where(good, cy_l, cy)
        cx = torch.where(good, cx_l, cx)
        fault = torch.maximum(fault, f)
        if lvl > 0:
            ratio = scales[lvl] / scales[lvl - 1]
            cy = cy * ratio
            cx = cx * ratio
    return cy, cx, fault


def track_pyramid(pyramid: Sequence[torch.Tensor], templates: KltTemplates,
                  ys: torch.Tensor, xs: torch.Tensor,
                  scales: Sequence[int], cfg: KltConfig):
    """Coarse-to-fine tracking of all N features (PyramidKltTracker.track).

    ys/xs: [N] full-resolution positions.  Returns (ys, xs, fault), fault
    the worst seen at any level.  CPU tensors take the plain version; CUDA
    tensors one launch of the ``klt_track`` kernel."""
    if cfg.method != "windowed":
        raise ValueError(
            f"KltConfig.method {cfg.method!r} is not ported: only "
            "'windowed' is (the 'gather' method is listed in ROADMAP.md, "
            "queue 1)")
    if ys.device.type == "cpu":
        return track_pyramid_reference(pyramid, templates, ys, xs, scales,
                                       cfg)
    f32 = lambda t: t.to(torch.float32).contiguous()
    cy, cx, fault, _ = klt_track_cuda(
        [f32(p) for p in pyramid], [f32(t) for t in templates.desc],
        [f32(t) for t in templates.grad_x], [f32(t) for t in templates.grad_y],
        f32(ys), f32(xs), scales, cfg.template_radius, cfg.max_iterations,
        cfg.max_per_pixel_error, cfg.min_determinant, cfg.convergence_tol)
    return cy, cx, fault
