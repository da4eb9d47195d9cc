"""Spherical / equirectangular (360) image transforms (port of
``boofcv_tpu/geo/spherical.py``, whole).

Reference analog: boofcv-geo alg/distort/spherical/ —
EquirectangularTools_F32.java:59 (pixel <-> unit-sphere direction),
CameraToEquirectangular_F64.java, EquirectangularRotate_F64.java,
MultiCameraToEquirectangular.java, and alg/distort/NarrowToWidePtoP_F64.java.

Every image transform is a dst->src warp grid on ``ip/distort.py`` (two
float32 [H, W] coordinate grids) applied as one batched bilinear gather,
on the image's device.  Camera frame: +x right, +y down, +z forward; the
equirect canvas's centre pixel looks along +z, longitude grows to the
right, latitude downward.
"""

from __future__ import annotations

import math

import torch

from boofcv_tpu_torch._config import resolve_device
from boofcv_tpu_torch.geo import cameras
from boofcv_tpu_torch.ip import distort


def equi_to_unit(x, y, width: int, height: int):
    """Equirect pixel -> unit direction [..., 3]
    (EquirectangularTools.equiToNorm).  Continuous coordinates; the
    horizontal axis wraps."""
    lon = (x / width - 0.5) * (2.0 * math.pi)
    lat = (y / (height - 1) - 0.5) * math.pi
    cl = torch.cos(lat)
    return torch.stack([cl * torch.sin(lon), torch.sin(lat),
                        cl * torch.cos(lon)], dim=-1)


def unit_to_equi(v, width: int, height: int):
    """Unit direction [..., 3] -> equirect pixel (x, y)
    (EquirectangularTools.normToEqui)."""
    lon = torch.atan2(v[..., 0], v[..., 2])
    lat = torch.asin(torch.clamp(v[..., 1], -1.0, 1.0))
    x = (lon / (2.0 * math.pi) + 0.5) * width
    y = (lat / math.pi + 0.5) * (height - 1)
    return x, y


def _equi_grid_dirs(height: int, width: int, device, dtype=torch.float32):
    ys, xs = torch.meshgrid(torch.arange(height, dtype=dtype, device=device),
                            torch.arange(width, dtype=dtype, device=device),
                            indexing="ij")
    return equi_to_unit(xs, ys, width, height)          # [H, W, 3]


def _mat(R, dtype, device):
    return torch.as_tensor(R, dtype=dtype, device=device)


def equi_rotate(image: torch.Tensor, R) -> torch.Tensor:
    """Rotate an equirect image: dst direction = R @ src direction
    (EquirectangularRotate_F64); the dst->src map uses Rᵀ."""
    h, w = image.shape[:2]
    d = _equi_grid_dirs(h, w, image.device)
    src = d @ _mat(R, torch.float32, image.device)       # Rᵀ d, batched
    mx, my = unit_to_equi(src, w, h)
    # horizontal wrap: warp() treats out-of-range as invalid, so fold x
    return distort.warp(image, my, torch.remainder(mx, w))


def equi_to_pinhole(equi: torch.Tensor, cam: cameras.CameraPinhole, R,
                    out_shape) -> torch.Tensor:
    """Extract a pinhole view from an equirect image
    (ExampleEquirectangularToPinhole): pinhole pixel -> ray -> rotated by
    the camera-to-world ``R`` -> equirect sample."""
    oh, ow = out_shape
    eh, ew = equi.shape[:2]
    Rm = _mat(R, torch.float32, equi.device)

    def tf(xs, ys):
        nx, ny = cameras.pixel_to_norm(cam, xs, ys)
        d = torch.stack([nx, ny, torch.ones_like(nx)], dim=-1)
        d = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)
        ex, ey = unit_to_equi(d @ Rm.T, ew, eh)          # rotate to world
        return torch.remainder(ex, ew), ey

    my, mx = distort.make_warp_grid(tf, oh, ow, device=equi.device)
    return distort.warp(equi, my, mx)


def camera_to_equi_grid(cam, R, equi_shape, dtype=torch.float32,
                        device=None):
    """CameraToEquirectangular: the dst->src map and validity rendering one
    camera (pinhole, Brown or universal-omni) onto the equirect canvas.
    Returns (map_y, map_x, valid [H, W]): directions behind the camera are
    invalid (out-of-frame ones are masked by ``distort.warp``).  ``device``
    None: the card."""
    dev = resolve_device(device)
    eh, ew = equi_shape
    d = _equi_grid_dirs(eh, ew, dev, dtype)              # world directions
    dc = d @ _mat(R, dtype, dev)                         # Rᵀ d: to camera
    if isinstance(cam, cameras.CameraUniversalOmni):
        mx, my = cameras.omni_project(cam, dc)
        # the sphere point must be in front of the projection centre
        # shifted by the mirror offset
        valid = dc[..., 2] + cam.mirror_offset > 1e-6
    else:
        z = dc[..., 2]
        zs = torch.where(torch.abs(z) < 1e-9, 1e-9, z)
        nx = dc[..., 0] / zs
        ny = dc[..., 1] / zs
        if isinstance(cam, cameras.CameraPinholeBrown):
            nx, ny = cameras.distort_norm(cam, nx, ny)
        mx, my = cameras.norm_to_pixel(cam, nx, ny)
        valid = z > 1e-6
    return my.to(dtype), mx.to(dtype), valid


def camera_to_equi(image: torch.Tensor, cam, R, equi_shape) -> torch.Tensor:
    """Render one camera image onto an equirect canvas (invalid -> 0)."""
    my, mx, valid = camera_to_equi_grid(cam, R, equi_shape,
                                        device=image.device)
    out = distort.warp(image, my, mx)
    if image.dim() == 3:
        valid = valid[..., None]
    return torch.where(valid, out, 0.0)


def multi_camera_to_equi(images, cams, Rs, equi_shape) -> torch.Tensor:
    """MultiCameraToEquirectangular: blend several cameras into one 360
    canvas.  Per-camera weights are the validity masks feathered by the
    distance to the source frame's edge (saturating at 10 px), normalized
    across cameras."""
    eh, ew = equi_shape
    dev = images[0].device
    acc = torch.zeros((eh, ew) + tuple(images[0].shape[2:]),
                      dtype=torch.float32, device=dev)
    wsum = torch.zeros((eh, ew), dtype=torch.float32, device=dev)
    for img, cam, R in zip(images, cams, Rs):
        my, mx, valid = camera_to_equi_grid(cam, R, equi_shape, device=dev)
        h, w = img.shape[:2]
        inb = valid & (my >= 0) & (my <= h - 1) & (mx >= 0) & (mx <= w - 1)
        edge = torch.minimum(torch.minimum(my, h - 1 - my),
                             torch.minimum(mx, w - 1 - mx))
        wgt = torch.where(inb, torch.clamp(edge / 10.0, 0.0, 1.0) + 1e-3,
                          0.0)
        smp = distort.warp(img, my, mx)
        acc = acc + (wgt[..., None] if acc.dim() == 3 else wgt) * smp
        wsum = wsum + wgt
    den = torch.clamp(wsum, min=1e-9)
    return acc / (den[..., None] if acc.dim() == 3 else den)


def narrow_to_wide(narrow_cam: cameras.CameraPinhole,
                   wide_cam: cameras.CameraUniversalOmni, R=None):
    """NarrowToWidePtoP_F64: ``f(x, y) -> (wx, wy)`` mapping narrow
    (pinhole) pixels to wide (universal-omni) pixels through the shared
    ray, with an optional narrow-to-wide rotation ``R`` (float64)."""
    def f(xs, ys):
        nx, ny = cameras.pixel_to_norm(narrow_cam, xs, ys)
        d = torch.stack([nx, ny, torch.ones_like(nx)], dim=-1)
        if R is not None:
            # float64 R promotes the ray, as in the reference
            d = d.to(torch.float64) @ _mat(R, torch.float64, d.device).T
        return cameras.omni_project(wide_cam, d)

    return f


def wide_to_narrow(wide_cam: cameras.CameraUniversalOmni,
                   narrow_cam: cameras.CameraPinhole, R=None):
    """Inverse of :func:`narrow_to_wide` (WideToNarrowPtoP): wide pixel ->
    unit ray -> rotated by Rᵀ -> pinhole pixel."""
    def f(xs, ys):
        d = cameras.omni_pixel_to_unit(wide_cam, xs, ys)
        if R is not None:
            d = d.to(torch.float64) @ _mat(R, torch.float64, d.device)
        z = torch.where(torch.abs(d[..., 2]) < 1e-9, 1e-9, d[..., 2])
        return cameras.norm_to_pixel(narrow_cam, d[..., 0] / z,
                                     d[..., 1] / z)

    return f
