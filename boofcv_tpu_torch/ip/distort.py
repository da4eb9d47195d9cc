"""Image warping / remap (port of ``boofcv_tpu/ip/distort.py``, whole).

Reference analog: boofcv-ip alg/distort/* (ImageDistortCache_SB).  The
dst->src map is built once as two [H, W] coordinate grids, then the warp is
one batched gather (``interpolate.bilinear`` or ``interpolate.nearest``);
samples whose source lies outside the image take ``fill_value``.

The grids are float32, as in the reference.  A function that takes an
image builds its grid on the image's device; :func:`make_warp_grid` alone
takes ``device`` (None: the card).
"""

from __future__ import annotations

import math
from typing import Callable, Tuple

import torch

from boofcv_tpu_torch._config import resolve_device
from boofcv_tpu_torch.ip import interpolate


def make_warp_grid(transform: Callable, height: int, width: int,
                   dtype=torch.float32,
                   device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Evaluate a dst->src pixel transform on the full grid.

    ``transform(xs, ys) -> (src_xs, src_ys)`` works on tensors.  Returns
    (map_y, map_x), each [H, W]."""
    dev = resolve_device(device)
    ys, xs = torch.meshgrid(torch.arange(height, dtype=dtype, device=dev),
                            torch.arange(width, dtype=dtype, device=dev),
                            indexing="ij")
    sx, sy = transform(xs, ys)
    return sy.to(dtype), sx.to(dtype)


def warp(image: torch.Tensor, map_y: torch.Tensor, map_x: torch.Tensor,
         method: str = "bilinear", fill_value: float = 0.0) -> torch.Tensor:
    """Apply a precomputed dst->src map; out-of-bounds -> fill_value."""
    if method == "bilinear":
        out = interpolate.bilinear(image, map_y, map_x)
    elif method == "nearest":
        out = interpolate.nearest(image, map_y, map_x)
    else:
        raise ValueError(method)
    h, w = image.shape[:2]
    valid = (map_y >= 0) & (map_y <= h - 1) & (map_x >= 0) & (map_x <= w - 1)
    if image.dim() == 3:
        valid = valid[..., None]
    return torch.where(valid, out, fill_value)


def warp_affine(image: torch.Tensor, a11, a12, a21, a22, tx, ty,
                out_shape=None, method="bilinear", fill_value=0.0):
    """Warp with the dst->src affine map [x'; y'] = A [x; y] + t
    (DistortImageOps.affine)."""
    h, w = out_shape if out_shape is not None else image.shape[:2]

    def tf(xs, ys):
        return a11 * xs + a12 * ys + tx, a21 * xs + a22 * ys + ty

    my, mx = make_warp_grid(tf, h, w, device=image.device)
    return warp(image, my, mx, method, fill_value)


def warp_homography(image: torch.Tensor, H_dst_to_src, out_shape=None,
                    method="bilinear", fill_value=0.0):
    """Warp with a dst->src homography (3x3), evaluated in float32."""
    h, w = out_shape if out_shape is not None else image.shape[:2]
    Hm = torch.as_tensor(H_dst_to_src, dtype=torch.float32,
                         device=image.device)

    def tf(xs, ys):
        d = Hm[2, 0] * xs + Hm[2, 1] * ys + Hm[2, 2]
        sx = (Hm[0, 0] * xs + Hm[0, 1] * ys + Hm[0, 2]) / d
        sy = (Hm[1, 0] * xs + Hm[1, 1] * ys + Hm[1, 2]) / d
        return sx, sy

    my, mx = make_warp_grid(tf, h, w, device=image.device)
    return warp(image, my, mx, method, fill_value)


def scale(image: torch.Tensor, out_shape, method="bilinear"):
    """Resize (DistortImageOps.scale).  The source coordinate is clamped to
    the last row and column, so an upscale keeps its far edge."""
    h_out, w_out = out_shape
    h, w = image.shape[:2]
    sy = h / h_out
    sx = w / w_out

    def tf(xs, ys):
        return (torch.clamp(xs * sx, max=w - 1.0),
                torch.clamp(ys * sy, max=h - 1.0))

    my, mx = make_warp_grid(tf, h_out, w_out, device=image.device)
    return warp(image, my, mx, method)


def rotate(image: torch.Tensor, angle: float, out_shape=None,
           method="bilinear"):
    """Rotate about the image centre (DistortImageOps.rotate)."""
    h, w = image.shape[:2]
    oh, ow = out_shape if out_shape is not None else (h, w)
    c, s = math.cos(angle), math.sin(angle)
    cx_src, cy_src = (w - 1) / 2.0, (h - 1) / 2.0
    cx_dst, cy_dst = (ow - 1) / 2.0, (oh - 1) / 2.0

    def tf(xs, ys):
        x = xs - cx_dst
        y = ys - cy_dst
        return c * x - s * y + cx_src, s * x + c * y + cy_src

    my, mx = make_warp_grid(tf, oh, ow, device=image.device)
    return warp(image, my, mx, method)
