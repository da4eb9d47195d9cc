"""Camera models and lens distortion (port of ``boofcv_tpu/geo/cameras.py``,
whole).

Reference analog: boofcv-geo struct/calib/CameraPinholeBrown.java,
alg/distort/brown/AddBrownPtoN_F64.java / RemoveBrownPtoN_F64.java,
LensDistortionOps.  Pinhole + Brown radial-tangential; the forward model
(normalized -> distorted pixel) is closed form, its inverse a fixed count
of fixed-point iterations.  Every function is elementwise over tensors of
any shape on any device.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Tuple

import torch

from boofcv_tpu_torch._config import resolve_device


@dataclass(frozen=True)
class CameraPinhole:
    """Intrinsics (struct/calib/CameraPinhole.java)."""
    fx: float
    fy: float
    cx: float
    cy: float
    skew: float = 0.0
    width: int = 0
    height: int = 0

    def K(self, dtype=torch.float64, device=None) -> torch.Tensor:
        """The 3x3 intrinsic matrix on ``device`` (None: the card)."""
        return torch.tensor([[self.fx, self.skew, self.cx],
                             [0.0, self.fy, self.cy],
                             [0.0, 0.0, 1.0]], dtype=dtype,
                            device=resolve_device(device))


@dataclass(frozen=True)
class CameraPinholeBrown(CameraPinhole):
    """Pinhole + Brown radial (r1..) and tangential (t1, t2) distortion
    (struct/calib/CameraPinholeBrown.java)."""
    radial: Tuple[float, ...] = (0.0, 0.0)
    t1: float = 0.0
    t2: float = 0.0


def pixel_to_norm(cam: CameraPinhole, px, py):
    """Pixel -> normalized image coords (PerspectiveOps.convertPixelToNorm)."""
    ny = (py - cam.cy) / cam.fy
    nx = (px - cam.cx - cam.skew * ny) / cam.fx
    return nx, ny


def norm_to_pixel(cam: CameraPinhole, nx, ny):
    px = cam.fx * nx + cam.skew * ny + cam.cx
    py = cam.fy * ny + cam.cy
    return px, py


def _radial(cam: CameraPinholeBrown, r2):
    """sum_i k_i r^2i, summed in the reference's order."""
    radial = torch.zeros_like(r2)
    rpow = r2
    for k in cam.radial:
        radial = radial + k * rpow
        rpow = rpow * r2
    return radial


def distort_norm(cam: CameraPinholeBrown, nx, ny):
    """Apply Brown distortion in normalized coords (AddBrownPtoN forward
    model): x_d = x (1 + sum k_i r^2i) + tangential."""
    r2 = nx * nx + ny * ny
    radial = _radial(cam, r2)
    xd = (nx * (1.0 + radial) + 2.0 * cam.t1 * nx * ny
          + cam.t2 * (r2 + 2.0 * nx * nx))
    yd = (ny * (1.0 + radial) + cam.t1 * (r2 + 2.0 * ny * ny)
          + 2.0 * cam.t2 * nx * ny)
    return xd, yd


def undistort_norm(cam: CameraPinholeBrown, xd, yd, iterations: int = 20):
    """Invert Brown distortion by ``iterations`` fixed-point steps
    (RemoveBrownPtoN_F64's scheme)."""
    nx, ny = xd, yd
    for _ in range(iterations):
        r2 = nx * nx + ny * ny
        radial = _radial(cam, r2)
        dx = 2.0 * cam.t1 * nx * ny + cam.t2 * (r2 + 2.0 * nx * nx)
        dy = cam.t1 * (r2 + 2.0 * ny * ny) + 2.0 * cam.t2 * nx * ny
        nx = (xd - dx) / (1.0 + radial)
        ny = (yd - dy) / (1.0 + radial)
    return nx, ny


def project(cam: CameraPinholeBrown, X):
    """Points in the camera frame [..., 3] -> distorted pixels (px, py)
    (BundlePinholeBrown's projection)."""
    nx = X[..., 0] / X[..., 2]
    ny = X[..., 1] / X[..., 2]
    xd, yd = distort_norm(cam, nx, ny)
    return norm_to_pixel(cam, xd, yd)


def pixel_to_norm_undistorted(cam: CameraPinholeBrown, px, py):
    """Distorted pixel -> undistorted normalized coords (LensDistortionOps
    narrow-FOV pixel_to_norm)."""
    xd, yd = pixel_to_norm(cam, px, py)
    return undistort_norm(cam, xd, yd)


@dataclass(frozen=True)
class CameraUniversalOmni(CameraPinholeBrown):
    """Unified omnidirectional model (struct/calib/CameraUniversalOmni.java):
    3-D ray -> unit sphere -> offset by ``mirror_offset`` along +z ->
    pinhole + Brown.  0 is a pinhole; about 1 an ultra-wide lens."""
    mirror_offset: float = 0.0


def omni_project(cam: CameraUniversalOmni, X):
    """Points in the camera frame [..., 3] -> distorted pixels."""
    n = torch.sqrt(torch.sum(X * X, dim=-1))
    n = torch.where(n < 1e-12, 1.0, n)
    sx = X[..., 0] / n
    sy = X[..., 1] / n
    sz = X[..., 2] / n + cam.mirror_offset
    xd, yd = distort_norm(cam, sx / sz, sy / sz)
    return norm_to_pixel(cam, xd, yd)


def omni_pixel_to_unit(cam: CameraUniversalOmni, px, py,
                       iterations: int = 20):
    """Distorted pixel -> unit 3-D ray: undistort to the normalized plane,
    then the closed-form inverse of the unit-sphere lift."""
    xd, yd = pixel_to_norm(cam, px, py)
    nx, ny = undistort_norm(cam, xd, yd, iterations)
    xi = cam.mirror_offset
    r2 = nx * nx + ny * ny
    f = (xi + torch.sqrt(1.0 + (1.0 - xi * xi) * r2)) / (1.0 + r2)
    return torch.stack([f * nx, f * ny, f - xi], dim=-1)


@dataclass(frozen=True)
class StereoParameters:
    """Stereo rig (struct/calib/StereoParameters.java) with the left-to-right
    transform: X_right = R @ X_left + t."""
    left: CameraPinholeBrown
    right: CameraPinholeBrown
    R_l2r: Tuple[Tuple[float, ...], ...]
    t_l2r: Tuple[float, ...]

    def R(self, dtype=torch.float64, device=None) -> torch.Tensor:
        return torch.tensor(self.R_l2r, dtype=dtype,
                            device=resolve_device(device))

    def t(self, dtype=torch.float64, device=None) -> torch.Tensor:
        return torch.tensor(self.t_l2r, dtype=dtype,
                            device=resolve_device(device))

    @property
    def baseline(self) -> float:
        return math.sqrt(sum(v * v for v in self.t_l2r))
