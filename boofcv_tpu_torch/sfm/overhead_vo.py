"""Monocular plane VO through a synthetic overhead (bird's-eye) view (port of
``boofcv_tpu/sfm/overhead_vo.py``).

Reference analog: boofcv-sfm alg/sfm/d3/VisOdomMonoOverheadMotion2D.java +
alg/sfm/overhead/CreateSyntheticOverheadView.java / OverheadView.java —
with known plane-to-camera extrinsics each frame is re-rendered as an
orthographic view of the ground plane in metric cells, 2-D rigid motion is
estimated between overhead frames, and the SE2 is lifted back to the
camera's SE3.

The overhead warp is a precomputed map applied as one bilinear lookup;
frame-to-frame motion is KLT in overhead space (``klt_track`` on the card)
and hypothesis-parallel RANSAC over a 2-point rigid SE2 solver, written
batched over the hypotheses and scored as one [K, N] reduction.  The SE2
accumulates on the host: a frame reads the host once (the model with its
inlier count).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from boofcv_tpu_torch._config import resolve_device
from boofcv_tpu_torch.core.pyramid import PyramidConfig
from boofcv_tpu_torch.feature import extract, klt
from boofcv_tpu_torch.geo import robust
from boofcv_tpu_torch.ip import pyramid_ops
from boofcv_tpu_torch.ip.interpolate import bilinear
from boofcv_tpu_torch.sfm import stereo_vo as svo


class OverheadMap(NamedTuple):
    """Precomputed overhead-pixel -> camera-pixel map."""
    map_x: torch.Tensor   # [OH, OW] f32 source pixel x
    map_y: torch.Tensor   # [OH, OW]
    valid: torch.Tensor   # [OH, OW] bool
    cell: float           # meters per overhead pixel
    center_x: float       # plane x of overhead pixel (0, 0)
    center_z: float       # plane z of overhead pixel (0, 0)


def create_overhead_map(K, R_pc, t_pc, img_h: int, img_w: int,
                        oh: int, ow: int, cell: float,
                        center_x: float, center_z: float,
                        device=None) -> OverheadMap:
    """CreateSyntheticOverheadView.configure analog, computed in float64
    and stored in float32 on ``device`` (None: the card).

    Plane frame: y = 0 is the plane, x right, z forward.  Overhead pixel
    (r, c) is the plane point x = center_x + c cell,
    z = center_z + (oh - 1 - r) cell (rows grow towards the camera, as in
    OverheadView.java).  (R_pc, t_pc): plane -> camera."""
    dev = resolve_device(device)
    f64 = lambda a: torch.as_tensor(np.asarray(a, np.float64), device=dev)
    K, R_pc, t_pc = f64(K), f64(R_pc), f64(t_pc)
    rr, cc = torch.meshgrid(
        torch.arange(oh, dtype=torch.float64, device=dev),
        torch.arange(ow, dtype=torch.float64, device=dev), indexing="ij")
    px = center_x + cc * cell
    pz = center_z + (oh - 1 - rr) * cell
    P = torch.stack([px, torch.zeros_like(px), pz], dim=-1)   # [OH, OW, 3]
    Pc = P @ R_pc.T + t_pc
    z = Pc[..., 2]
    u = K[0, 0] * Pc[..., 0] / z + K[0, 2]
    v = K[1, 1] * Pc[..., 1] / z + K[1, 2]
    valid = ((z > 1e-6) & (u >= 0) & (u <= img_w - 1) & (v >= 0)
             & (v <= img_h - 1))
    return OverheadMap(u.to(torch.float32), v.to(torch.float32), valid,
                       float(cell), float(center_x), float(center_z))


def render_overhead(image, omap: OverheadMap) -> torch.Tensor:
    """One bilinear lookup: camera frame -> overhead view (0 off the
    image)."""
    vals = bilinear(image.to(torch.float32), omap.map_y, omap.map_x)
    return torch.where(omap.valid, vals, 0.0)


# ---------------------------------------------------------------------------
# Rigid SE2 robust estimation (MotionSe2PointSVD / ImageMotion2D analog)
# ---------------------------------------------------------------------------

def _se2_from_two(sample):
    """Closed-form rigid 2-D motion of two correspondences, batched: p, q
    [..., 2, 2] -> ([..., 3] = (angle, tx, ty),)."""
    p, q = sample
    dp = p[..., 1, :] - p[..., 0, :]
    dq = q[..., 1, :] - q[..., 0, :]
    # the rotation taking dp onto dq
    cross = dp[..., 0] * dq[..., 1] - dp[..., 1] * dq[..., 0]
    dot = dp[..., 0] * dq[..., 0] + dp[..., 1] * dq[..., 1]
    ang = torch.atan2(cross, dot)
    ca, sa = torch.cos(ang), torch.sin(ang)
    pm = (p[..., 0, :] + p[..., 1, :]) * 0.5
    qm = (q[..., 0, :] + q[..., 1, :]) * 0.5
    tx = qm[..., 0] - (ca * pm[..., 0] - sa * pm[..., 1])
    ty = qm[..., 1] - (sa * pm[..., 0] + ca * pm[..., 1])
    return (torch.stack([ang, tx, ty], dim=-1),)


def _se2_apply(model, p):
    """Models [..., 3] applied to points [..., 2] (broadcast)."""
    ang, tx, ty = model[..., 0], model[..., 1], model[..., 2]
    ca, sa = torch.cos(ang), torch.sin(ang)
    x = ca * p[..., 0] - sa * p[..., 1] + tx
    y = sa * p[..., 0] + ca * p[..., 1] + ty
    return torch.stack([x, y], dim=-1)


def _se2_scorer(models, points):
    """[K, N] squared transfer errors of models [K, 3] on points [N, 2]."""
    p, q = points
    d = _se2_apply(models[0][..., :, None, :], p[..., None, :, :]) \
        - q[..., None, :, :]
    return torch.sum(d * d, dim=-1)


def ransac_se2(generator, p, q, num_hypotheses: int = 256,
               inlier_threshold_px: float = 2.0, valid_mask=None,
               idx=None) -> robust.RansacResult:
    """Robust rigid SE2 p -> q (pixels, [N, 2]): RANSAC over 2-point
    samples (``idx`` [K, 2] replaces the draw), then a Procrustes refit on
    the inliers (MotionSe2PointSVD).  The model is [3] = (angle, tx, ty)."""
    res = robust.ransac(generator, (p, q), _se2_from_two, _se2_scorer, 2,
                        num_hypotheses, inlier_threshold_px ** 2,
                        valid_mask=valid_mask, idx=idx)
    w = res.inliers.to(p.dtype)
    wsum = torch.clamp(torch.sum(w, dim=-1), min=1.0)[..., None]
    pm = torch.sum(p * w[..., None], dim=-2) / wsum
    qm = torch.sum(q * w[..., None], dim=-2) / wsum
    pc = (p - pm[..., None, :]) * w[..., None]
    qc = q - qm[..., None, :]
    sxx = torch.sum(pc[..., 0] * qc[..., 0] + pc[..., 1] * qc[..., 1], dim=-1)
    sxy = torch.sum(pc[..., 0] * qc[..., 1] - pc[..., 1] * qc[..., 0], dim=-1)
    ang = torch.atan2(sxy, sxx)
    ca, sa = torch.cos(ang), torch.sin(ang)
    tx = qm[..., 0] - (ca * pm[..., 0] - sa * pm[..., 1])
    ty = qm[..., 1] - (sa * pm[..., 0] + ca * pm[..., 1])
    return res._replace(model=torch.stack([ang, tx, ty], dim=-1))


class MonoOverheadVisualOdometry:
    """Host front end.  (R_pc, t_pc): plane -> camera extrinsics (plane frame:
    y = 0 ground, z forward); cell: meters per overhead pixel.  Runs on
    ``device`` (None: the card; raises without one)."""

    def __init__(self, K, R_pc, t_pc, img_h: int, img_w: int,
                 overhead_shape=(320, 320), cell: float = 0.03,
                 center_x: float | None = None, center_z: float = 0.5,
                 num_tracks: int = 300, scales=(1, 2), seed: int = 0,
                 device=None):
        oh, ow = overhead_shape
        if center_x is None:
            center_x = -0.5 * ow * cell
        self.device = resolve_device(device)
        self.omap = create_overhead_map(K, R_pc, t_pc, img_h, img_w, oh, ow,
                                        cell, center_x, center_z,
                                        self.device)
        self.oh, self.ow = oh, ow
        self.scales = tuple(scales)
        self.n = num_tracks
        self.rng = svo._generator(self.device, seed)
        self.cfg = klt.KltConfig(template_radius=3)
        # plane motion accumulated as SE2 in overhead pixels: cur -> first
        self.se2 = np.array([0.0, 0.0, 0.0])
        self.R_pc = np.asarray(R_pc, np.float64)
        self.t_pc = np.asarray(t_pc, np.float64)
        self._tracks = None
        self._tmpl = None

    def _retrack(self, over, pyr):
        """Fresh detections and their templates on this overhead frame."""
        ys, xs, valid = extract.detect_tracks(over, max_features=self.n)
        self._tmpl = klt.sample_templates(pyr, pyramid_ops.gradient(pyr), ys,
                                          xs, self.scales,
                                          self.cfg.template_radius)
        self._tracks = (ys, xs, valid)

    def process(self, image) -> bool:
        over = render_overhead(torch.as_tensor(image, device=self.device),
                               self.omap)
        pyr = pyramid_ops.pyramid_average(over, PyramidConfig(self.scales))
        if self._tracks is None:
            self._retrack(over, pyr)
            return True

        ys, xs, valid = self._tracks
        nys, nxs, fault = klt.track_pyramid(pyr, self._tmpl, ys, xs,
                                            self.scales, self.cfg)
        ok = valid & (fault == klt.TRACK_OK)
        p = torch.stack([xs, ys], dim=-1).to(torch.float64)
        q = torch.stack([nxs, nys], dim=-1).to(torch.float64)
        res = ransac_se2(self.rng, p, q, valid_mask=ok)
        # the frame's one host read: the model and its inlier count together
        ang, tx, ty, n_inl = torch.cat([
            res.model, res.num_inliers.reshape(1).to(torch.float64)]).tolist()
        if n_inl < 8:
            return False
        # the model maps previous -> current overhead pixels; accumulate
        # current -> first.  Inverse of (ang, t): (-ang, -R(-ang) t)
        a0, x0, y0 = self.se2
        ca, sa = np.cos(-ang), np.sin(-ang)
        ix = -(ca * tx - sa * ty)
        iy = -(sa * tx + ca * ty)
        # compose: first <- previous o previous <- current
        c0, s0 = np.cos(a0), np.sin(a0)
        self.se2 = np.array([a0 - ang, x0 + c0 * ix - s0 * iy,
                             y0 + s0 * ix + c0 * iy])
        self._retrack(over, pyr)
        return True

    def plane_motion(self):
        """Current camera position on the plane: (x, z, yaw) in meters
        relative to the first frame.

        The SE2 lives in overhead pixels; plane coords are u = A p + b with
        A = diag(cell, -cell) and b the plane point of pixel (0, 0).
        Conjugating gives the translation A t + (I - R) b (the reference
        dropped the (I - R) b term once, a phantom |b| angle)."""
        ang, tx, ty = self.se2
        cell = self.omap.cell
        bx = self.omap.center_x
        bz = self.omap.center_z + (self.oh - 1) * cell
        ca, sa = np.cos(ang), np.sin(ang)
        x = cell * tx + (1.0 - ca) * bx - sa * bz
        z = -cell * ty + sa * bx + (1.0 - ca) * bz
        return float(x), float(z), float(ang)

    def camera_to_world(self):
        """Camera->world SE3 (world = the plane frame at the first frame)."""
        x, z, yaw = self.plane_motion()
        cy, sy = np.cos(yaw), np.sin(yaw)
        R_plane = np.array([[cy, 0.0, sy], [0.0, 1.0, 0.0],
                            [-sy, 0.0, cy]])
        t_plane = np.array([x, 0.0, z])
        # camera -> plane (now), then plane (now) -> plane (first) = world
        R_cp = self.R_pc.T
        t_cp = -self.R_pc.T @ self.t_pc
        return R_plane @ R_cp, R_plane @ t_cp + t_plane
