"""Batched pyramidal KLT tracker (port of ``boofcv_tpu/feature/klt.py``).

Reference analog: boofcv-feature alg/tracker/klt/KltTracker.java:55
(inverse-compositional translation-only KLT), PyramidKltTracker.java:37
(coarse-to-fine), KltTrackFault.java (fault codes).

Two level methods, as in the reference.  ``"windowed"`` (the default, and
the VO's) gathers every track's 24x16 neighbourhood once per level, then
each Gauss-Newton iteration resamples the patch inside that window.
``"gather"`` resamples the patch from the image at every iteration; it has
no window to run out of, and is kept as the equivalence oracle.

Every function takes one stream (positions [N], templates [N, P, P],
pyramid levels [h, w]) or B streams with a leading axis on all three
([B, N], [B, N, P, P], [B, h, w]); streams never couple.

:func:`track_pyramid` dispatches by device, never by failure.  For the
windowed method CUDA tensors go to one launch of
``kernels/csrc/klt_track.cu``, whatever B is: it keeps each track's window
in shared memory and runs every level's iterations there.  CPU tensors take
:func:`track_pyramid_reference`, the plain PyTorch version of the same
function: it gathers the windows through ``kernels.window_gather`` and
turns the reference's early-exit ``while_loop`` into a fixed
``max_iterations`` loop with a per-track frozen flag (converged tracks
already take zero steps there, so the results are the same).  The gather
method is plain PyTorch on either device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Sequence, Tuple

import torch

from boofcv_tpu_torch.ip.interpolate import (sample_rect_bilinear,
                                             sample_rect_bilinear_multi)
from boofcv_tpu_torch.kernels.klt_track import klt_track_cuda
from boofcv_tpu_torch.kernels.window_gather import (aligned_window_origin,
                                                    as_planes, gather_windows)

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
    method: str = "windowed"      # or "gather"


class KltTemplates(NamedTuple):
    """Per-track templates at every pyramid level: desc[level] is
    [N, P, P] (or [B, N, P, P]), grad_x / grad_y likewise."""
    desc: Tuple[torch.Tensor, ...]
    grad_x: Tuple[torch.Tensor, ...]
    grad_y: Tuple[torch.Tensor, ...]


def sample_templates(pyramid: Sequence[torch.Tensor],
                     grads: Tuple[Sequence[torch.Tensor],
                                  Sequence[torch.Tensor]],
                     ys: torch.Tensor, xs: torch.Tensor,
                     scales: Sequence[int], radius: int) -> KltTemplates:
    """Template + gradient patches at every level for N features at
    level-0 float coordinates (ys, xs) [..., N] on [..., h, w] levels."""
    dxs, dys = grads
    desc, gx, gy = [], [], []
    for lvl, s in enumerate(scales):
        stack = torch.stack([pyramid[lvl], dxs[lvl], dys[lvl]], dim=-3)
        d, g1, g2 = sample_rect_bilinear_multi(stack, ys / s, xs / s,
                                               radius).unbind(-4)
        desc.append(d)
        gx.append(g1)
        gy.append(g2)
    return KltTemplates(tuple(desc), tuple(gx), tuple(gy))


def _resample(win: torch.Tensor, py: torch.Tensor, px: torch.Tensor,
              p: int, margin_y: float, margin_x: float) -> torch.Tensor:
    """[..., N, P, P] patch at in-window top-left (py, px): x interpolation
    of the P+1 rows the patch needs, then y interpolation: the two nonzero
    taps per row of the reference's one-hot Wy @ (window @ Wx^T)
    (``_interp_matrix``), taken directly."""
    lead = py.shape
    py = torch.clamp(py, 0.0, margin_y)
    px = torch.clamp(px, 0.0, margin_x)
    by = torch.floor(py)
    bx = torch.floor(px)
    fy = (py - by)[..., None, None]
    fx = (px - bx)[..., None, None]
    k = torch.arange(p + 1, device=win.device)
    rows = (by.long()[..., None] + k)[..., None].expand(
        lead + (p + 1, win.shape[-1]))
    band = win.gather(-2, rows)                             # [..., P+1, WX]
    cols = (bx.long()[..., None] + k[:p])[..., None, :].expand(
        lead + (p + 1, p))
    t = (1 - fx) * band.gather(-1, cols) + fx * band.gather(-1, cols + 1)
    return (1 - fy) * t[..., :p, :] + fy * t[..., 1:, :]


def _normal_matrix(gx, gy, cfg: KltConfig):
    """The 2x2 Gauss-Newton system of each template (KltTracker
    precomputes Gxx, Gxy, Gyy) and whether it is regular enough."""
    gxx = torch.sum(gx * gx, dim=(-2, -1))
    gxy = torch.sum(gx * gy, dim=(-2, -1))
    gyy = torch.sum(gy * gy, dim=(-2, -1))
    det = gxx * gyy - gxy * gxy
    area = gx.shape[-1] * gx.shape[-2]
    return (gxx, gxy, gyy, torch.where(det == 0, 1.0, det),
            det / area >= cfg.min_determinant)


def _gn_steps(sample, desc, gx, gy, normal, py, px, steps: int,
              cfg: KltConfig):
    """``steps`` Gauss-Newton steps from (py, px), ``sample(py, px)`` giving
    the current patch; a track takes no step once one of its steps fell
    below the tolerance.  Returns (py, px, mean |error| of the last
    evaluation)."""
    gxx, gxy, gyy, safe_det, _ = normal
    done = torch.zeros(py.shape, dtype=torch.bool, device=py.device)
    per_pixel = torch.zeros(py.shape, dtype=torch.float32, device=py.device)
    for _ in range(steps):
        err = sample(py, px) - desc
        per_pixel = torch.mean(torch.abs(err), dim=(-2, -1))
        bx_ = torch.sum(err * gx, dim=(-2, -1))
        by_ = torch.sum(err * gy, dim=(-2, -1))
        dx = (gyy * bx_ - gxy * by_) / safe_det
        dy = (gxx * by_ - gxy * bx_) / safe_det
        py = py - torch.where(done, 0.0, dy)
        px = px - torch.where(done, 0.0, dx)
        done = done | ((torch.abs(dx) < cfg.convergence_tol)
                       & (torch.abs(dy) < cfg.convergence_tol))
    return py, px, per_pixel


def _level_fault(per_pixel, ok_det, in_bounds, cfg: KltConfig):
    fault = torch.full(per_pixel.shape, TRACK_OK, dtype=torch.int32,
                       device=per_pixel.device)
    fault = torch.where(per_pixel > cfg.max_per_pixel_error,
                        FAULT_LARGE_ERROR, fault)
    fault = torch.where(~ok_det, FAULT_FAILED, fault)
    return torch.where(~in_bounds, FAULT_OUT_OF_BOUNDS, fault)


def _track_level_windowed(image, desc, gx, gy, cy, cx, cfg: KltConfig):
    """One KLT level for all tracks: one window gather, then a fixed count
    of Gauss-Newton steps inside the windows.  Tracks whose motion reaches
    the window edge clamp there and fault out-of-bounds."""
    r = cfg.template_radius
    p = 2 * r + 1
    wy_sz = 24 if p + 2 <= 16 else 32
    wx_sz = 16 if p + 2 <= 16 else 32
    h, w = image.shape[-2:]
    img = as_planes(image)
    dt = torch.float32
    normal = _normal_matrix(gx, gy, cfg)

    cy = cy.to(dt)
    cx = cx.to(dt)
    oy, ox, py, px = aligned_window_origin(cy, cx, r, h, w, wy_sz, wx_sz)
    win = gather_windows(img, oy.contiguous(), ox.contiguous(), wy_sz, wx_sz)

    margin_y = float(wy_sz - p - 1)
    margin_x = float(wx_sz - p - 1)
    py, px, per_pixel = _gn_steps(
        lambda y, x: _resample(win, y, x, p, margin_y, margin_x), desc, gx,
        gy, normal, py, px, cfg.max_iterations, cfg)

    cy_out = torch.clamp(py, 0.0, margin_y) + r + oy.to(dt)
    cx_out = torch.clamp(px, 0.0, margin_x) + r + ox.to(dt)
    in_bounds = ((cy_out >= r) & (cy_out <= h - 1 - r)
                 & (cx_out >= r) & (cx_out <= w - 1 - r)
                 & (py > 0) & (py < margin_y) & (px > 0) & (px < margin_x))
    return cy_out, cx_out, _level_fault(per_pixel, normal[4], in_bounds, cfg)


def _track_level_gather(image, desc, gx, gy, cy, cx, cfg: KltConfig):
    """One KLT level by the gather method (the reference's ``_track_level``):
    every step samples the patch from the image at the current position, so
    a track can move as far as its steps carry it.

    The reference's loop takes two steps per trip and leaves when every
    track is done, so it runs ``max_iterations`` rounded up to even; steps
    after that exit would move nothing and re-evaluate the same error, so
    the fixed count here gives the same result."""
    r = cfg.template_radius
    h, w = image.shape[-2:]
    img = image.to(torch.float32)
    normal = _normal_matrix(gx, gy, cfg)
    cy, cx, per_pixel = _gn_steps(
        lambda y, x: sample_rect_bilinear(img, y, x, r), desc, gx, gy,
        normal, cy, cx, 2 * ((cfg.max_iterations + 1) // 2), cfg)
    in_bounds = ((cy >= r) & (cy <= h - 1 - r)
                 & (cx >= r) & (cx <= w - 1 - r))
    return cy, cx, _level_fault(per_pixel, normal[4], in_bounds, cfg)


_LEVEL_METHODS = {"windowed": _track_level_windowed,
                  "gather": _track_level_gather}


def _level_method(cfg: KltConfig):
    try:
        return _LEVEL_METHODS[cfg.method]
    except KeyError:
        raise ValueError(f"unknown KltConfig.method {cfg.method!r}: "
                         "'windowed' or 'gather'") from None


def track_pyramid_reference(pyramid: Sequence[torch.Tensor],
                            templates: KltTemplates, ys: torch.Tensor,
                            xs: torch.Tensor, scales: Sequence[int],
                            cfg: KltConfig):
    """The plain PyTorch version of :func:`track_pyramid` (either method),
    level by level, on whatever device the tensors lie."""
    track_level = _level_method(cfg)
    fault = torch.full(ys.shape, TRACK_OK, dtype=torch.int32,
                       device=ys.device)
    cy = ys / scales[-1]
    cx = xs / scales[-1]
    for lvl in range(len(scales) - 1, -1, -1):
        cy_l, cx_l, f = track_level(
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
    """Coarse-to-fine tracking of all features (PyramidKltTracker.track).

    ys/xs: [N] or [B, N] full-resolution positions.  Returns (ys, xs,
    fault), fault the worst seen at any level.  The windowed method takes
    the plain version on CPU tensors and one launch of the ``klt_track``
    kernel on CUDA tensors; the gather method is the plain version on
    either."""
    _level_method(cfg)
    if ys.device.type == "cpu" or cfg.method == "gather":
        return track_pyramid_reference(pyramid, templates, ys, xs, scales,
                                       cfg)
    f32 = lambda t: t.to(torch.float32).contiguous()
    cy, cx, fault, _ = klt_track_cuda(
        [as_planes(p) for p in pyramid], [f32(t) for t in templates.desc],
        [f32(t) for t in templates.grad_x], [f32(t) for t in templates.grad_y],
        f32(ys), f32(xs), scales, cfg.template_radius, cfg.max_iterations,
        cfg.max_per_pixel_error, cfg.min_determinant, cfg.convergence_tol)
    return cy, cx, fault
