"""Direct (dense photometric) RGB-D visual odometry (port of
``boofcv_tpu/sfm/direct_vo.py``).

Reference analog: boofcv-sfm alg/sfm/d3/direct/VisOdomDirectColorDepth.java
— photometric Gauss-Newton on an RGB-D pyramid: minimize
sum_p (I_cur(warp(p, xi)) - I_key(p))^2 over the se(3) increment.

Each GN iteration warps every keyframe pixel through the pose (float64),
samples the current image bilinearly at the float32-cast coordinates, and
builds the [H, W, 6] Jacobian by forward-mode differentiation along the six
basis directions (``torch.func.jvp``, batched over the directions with
``torch.func.vmap``), as the reference does with ``jax.jvp``: the floor and
the integer taps of ``ip/interpolate.bilinear`` carry no tangent, and the
tangent goes through the same float32 cast as the coordinates.  Coarse to
fine over the pyramid, a fixed count of iterations a level, no host sync
inside :func:`make_direct_step`'s estimator.
"""

from __future__ import annotations

import numpy as np
import torch

from boofcv_tpu_torch._config import resolve_device
from boofcv_tpu_torch.core.pyramid import PyramidConfig
from boofcv_tpu_torch.geo import se3
from boofcv_tpu_torch.geo.smalllinalg import solve_spd
from boofcv_tpu_torch.ip import pyramid_ops
from boofcv_tpu_torch.ip.interpolate import bilinear


def _level_K(K, scale):
    K = np.asarray(K, np.float64)
    Ks = K.copy()
    Ks[0, 0] /= scale
    Ks[1, 1] /= scale
    Ks[0, 2] = (K[0, 2] + 0.5) / scale - 0.5
    Ks[1, 2] = (K[1, 2] + 0.5) / scale - 0.5
    return Ks


def _level_residual(img_k, img_c, depth, Kl, min_depth: float):
    """residual(xi, R, t) -> (r [h, w] f64, weight [h, w] f64) of one
    pyramid level: the photometric error of every keyframe pixel with valid
    depth warped through exp(xi) o (R, t), zero outside the image."""
    fx, fy, cx, cy = (float(Kl[0, 0]), float(Kl[1, 1]), float(Kl[0, 2]),
                      float(Kl[1, 2]))
    h, w = img_k.shape
    ys, xs = torch.meshgrid(
        torch.arange(h, dtype=torch.float64, device=img_k.device),
        torch.arange(w, dtype=torch.float64, device=img_k.device),
        indexing="ij")
    z = depth.to(torch.float64)
    valid0 = z > min_depth
    X = torch.stack([(xs - cx) / fx * z, (ys - cy) / fy * z, z], dim=-1)

    def residual(xi, R, t):
        dR, dt = se3.exp_se3(xi)
        Rc, tc = se3.compose(dR, dt, R, t)
        Xc = X @ Rc.T + tc
        zc = torch.clamp(Xc[..., 2], min=1e-6)
        u = Xc[..., 0] / zc * fx + cx
        v = Xc[..., 1] / zc * fy + cy
        inb = ((u >= 1) & (u <= w - 2) & (v >= 1) & (v <= h - 2) & valid0
               & (Xc[..., 2] > min_depth))
        warped = bilinear(img_c, v.to(torch.float32), u.to(torch.float32))
        r = (warped - img_k).to(torch.float64)
        wgt = inb.to(torch.float64)
        return r * wgt, wgt

    return residual


def _residual_jacobian(residual, R, t):
    """(r [h, w], weight, J [h, w, 6]) at xi = 0: J[..., i] the derivative
    of r along the i-th basis direction of se(3), by forward mode."""
    xi0 = torch.zeros((6,), dtype=torch.float64, device=R.device)
    r0, wgt = residual(xi0, R, t)
    eye = torch.eye(6, dtype=torch.float64, device=R.device)
    jv = torch.func.vmap(lambda e: torch.func.jvp(
        lambda x: residual(x, R, t)[0], (xi0,), (e,))[1])(eye)
    return r0, wgt, jv.permute(1, 2, 0)


def make_direct_step(K, scales=(1, 2, 4), iterations_per_level: int = 10,
                     min_depth: float = 1e-3):
    """Relative-pose estimator between a keyframe (gray + depth) and the
    current gray image: fn(key_gray, key_depth, cur_gray, R0, t0) ->
    (R, t, rmse), tensors on the inputs' device; (R, t) maps keyframe
    camera coords to current camera coords, starting from (R0, t0)."""
    pyr_cfg = PyramidConfig(scales=tuple(scales))
    Ks = [_level_K(K, s) for s in scales]

    def estimate(key_gray, key_depth, cur_gray, R0, t0):
        kp = pyramid_ops.pyramid_average(key_gray.to(torch.float32), pyr_cfg)
        cp = pyramid_ops.pyramid_average(cur_gray.to(torch.float32), pyr_cfg)
        # depth pyramid: stride sampling (depth is piecewise smooth), cropped
        # to the image pyramid's level shape
        dp = [key_depth.to(torch.float32)[::s, ::s] for s in scales]
        R, t = R0.to(torch.float64), t0.to(torch.float64)
        eye6 = torch.eye(6, dtype=torch.float64, device=R.device)
        for lvl in range(len(scales) - 1, -1, -1):
            h, w = kp[lvl].shape
            residual = _level_residual(kp[lvl], cp[lvl], dp[lvl][:h, :w],
                                       Ks[lvl], min_depth)
            for _ in range(iterations_per_level):
                r0, _, J = _residual_jacobian(residual, R, t)
                Jf = J.reshape(-1, 6)
                H6 = Jf.T @ Jf + 1e-6 * eye6
                dx = -solve_spd(H6, Jf.T @ r0.reshape(-1))
                dR, dt = se3.exp_se3(dx)
                R, t = se3.compose(dR, dt, R, t)
            r0, wgt = residual(torch.zeros_like(eye6[0]), R, t)
            rmse = torch.sqrt(torch.sum(r0 * r0)
                              / torch.clamp(torch.sum(wgt), min=1.0))
        return R, t, rmse

    return estimate


class DirectDepthVisualOdometry:
    """Keyframe front end on ``device`` (None: the card; raises without one):
    accumulates the world pose and re-keys when the photometric error
    grows.  A frame uploads the starting pose and reads (R, t, rmse) back
    once."""

    def __init__(self, K, scales=(1, 2, 4), rekey_rmse: float = 20.0,
                 device=None):
        self.device = resolve_device(device)
        self._est = make_direct_step(K, scales)
        self.rekey_rmse = rekey_rmse
        self.R_wk = np.eye(3)       # keyframe->world
        self.t_wk = np.zeros(3)
        self._key = None
        self.R_cw = np.eye(3)       # world->current
        self.t_cw = np.zeros(3)
        self.last_rmse = float("nan")

    def _tensor(self, a):
        return torch.as_tensor(a, device=self.device)

    def process(self, gray, depth) -> bool:
        if self._key is None:
            self._key = (self._tensor(gray), self._tensor(depth))
            return True
        kg, kd = self._key
        # warm start from the last keyframe->current estimate: far from the
        # keyframe the GN otherwise restarts from identity each frame and
        # can stall in a local minimum
        R_kw = self.R_wk.T
        t_kw = -R_kw @ self.t_wk
        R0 = self.R_cw @ self.R_wk
        t0 = self.R_cw @ self.t_wk + self.t_cw
        cur = self._tensor(gray)
        R, t, rmse = self._est(kg, kd, cur, self._tensor(R0),
                               self._tensor(t0))
        host = torch.cat([R.reshape(9), t, rmse.reshape(1)]).cpu().numpy()
        R, t, rmse = host[:9].reshape(3, 3), host[9:12], float(host[12])
        self.last_rmse = rmse
        # world->current = (keyframe->current) o (world->keyframe)
        self.R_cw = R @ R_kw
        self.t_cw = R @ t_kw + t
        if rmse > self.rekey_rmse:
            # re-key at the current frame
            self.R_wk = self.R_cw.T
            self.t_wk = -self.R_cw.T @ self.t_cw
            self._key = (cur, self._tensor(depth))
        return bool(np.isfinite(rmse))

    def camera_to_world(self):
        return self.R_cw.T, -self.R_cw.T @ self.t_cw
