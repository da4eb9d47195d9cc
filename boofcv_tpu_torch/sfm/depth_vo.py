"""RGB-D visual odometry (port of ``boofcv_tpu/sfm/depth_vo.py``).

Reference analog: boofcv-sfm abst/sfm/d3/DepthVisualOdometry.java with
alg/sfm/DepthSparse3D.java (3-D from a registered depth image) driving the
VisOdomPixelDepthPnP loop of the stereo version.

The stereo step with the sparse stereo swapped for a depth lookup: the
same track pool (``stereo_vo.StereoVoState``), KLT, RANSAC-P3P and spawn
compaction.  One host sync a step decides the spawn, as in the stereo
step; the spawn also assigns track uids as the stereo spawn does (the
reference's leaves them at -1).
"""

from __future__ import annotations

import numpy as np
import torch

from boofcv_tpu_torch._config import resolve_device
from boofcv_tpu_torch.core.pyramid import PyramidConfig
from boofcv_tpu_torch.feature import extract, klt
from boofcv_tpu_torch.geo import robust, se3
from boofcv_tpu_torch.ip import pyramid_ops
from boofcv_tpu_torch.sfm import stereo_vo as svo


def _spawn(state: svo.StereoVoState, pyramid, grads, gray, depth,
           intrinsics, cfg: svo.StereoVoConfig) -> svo.StereoVoState:
    """Fill dead slots with fresh detections lifted through the depth image
    (DepthSparse3D.process: X = z K^-1 [x, y, 1])."""
    fx, fy, cx, cy = intrinsics
    det = svo._detect_candidates(gray, cfg, cfg.num_tracks)
    cand_y = det.ys.to(torch.float32)
    cand_x = det.xs.to(torch.float32)
    cand_ok = det.valid & ~extract.near_live(cand_x, cand_y, state.xs,
                                             state.ys, state.alive,
                                             cfg.detect_radius)
    z = depth[det.ys.long(), det.xs.long()]
    cand_ok = cand_ok & (z > 1e-6)
    xn = (cand_x - cx) / fx
    yn = (cand_y - cy) / fy
    Xc = torch.stack([xn * z, yn * z, z], dim=-1).to(torch.float64)
    return svo._fill_slots(state, cand_x, cand_y, cand_ok, Xc, pyramid,
                           grads, cfg)


def make_step(cfg: svo.StereoVoConfig, K):
    """(step, boot): step(state, gray, depth) -> (state, metrics) and
    boot(state, gray, depth) -> state, on tensors on the state's device.

    depth: [H, W] metric depth (0 = invalid) registered to the gray
    image."""
    K = np.asarray(K, np.float64)
    intrinsics = (float(K[0, 0]), float(K[1, 1]), float(K[0, 2]),
                  float(K[1, 2]))
    fx, fy, cx, cy = intrinsics
    norm_thresh = (cfg.inlier_threshold_px / fx) ** 2
    pyr_cfg = PyramidConfig(scales=cfg.pyramid_scales)

    def step(state: svo.StereoVoState, gray, depth):
        gray = gray.to(torch.float32)
        pyramid = pyramid_ops.pyramid_average(gray, pyr_cfg)
        nys, nxs, fault = klt.track_pyramid(
            pyramid, state.templates, state.ys, state.xs,
            cfg.pyramid_scales, cfg.klt)
        tracked = state.alive & (fault == klt.TRACK_OK)
        xs = torch.where(tracked, nxs, state.xs)
        ys = torch.where(tracked, nys, state.ys)

        obs = torch.stack([(xs - cx) / fx, (ys - cy) / fy], dim=-1)
        rng = svo._fork(state.rng)
        res, (Rn, tn) = robust.ransac_pnp(
            rng, state.world, obs.to(torch.float64),
            num_hypotheses=cfg.ransac_hypotheses,
            inlier_threshold=norm_thresh, valid_mask=tracked,
            refine_iterations=cfg.refine_iterations)
        ok = res.num_inliers >= 6
        Rn = torch.where(ok, Rn, state.R)
        tn = torch.where(ok, tn, state.t)
        # prune only on an accepted pose (a failed RANSAC's mask is junk)
        alive = tracked & (res.inliers | ~ok)
        new_state = state._replace(xs=xs, ys=ys, alive=alive, R=Rn, t=tn,
                                   rng=rng)
        # the step's one host sync: spawn when the pool runs low
        if bool(torch.mean(alive.to(torch.float32)) < cfg.respawn_below):
            new_state = _spawn(new_state, pyramid,
                               pyramid_ops.gradient(pyramid), gray, depth,
                               intrinsics, cfg)
        return new_state, {"tracked": torch.sum(tracked),
                           "inliers": res.num_inliers,
                           "alive": torch.sum(new_state.alive),
                           "pose_ok": ok}

    def boot(state: svo.StereoVoState, gray, depth):
        gray = gray.to(torch.float32)
        pyramid = pyramid_ops.pyramid_average(gray, pyr_cfg)
        return _spawn(state, pyramid, pyramid_ops.gradient(pyramid), gray,
                      depth, intrinsics, cfg)

    return step, boot


class DepthVisualOdometry:
    """Host front end (abst DepthVisualOdometry analog): owns the state on
    ``device`` (None: the card; raises without one)."""

    def __init__(self, cfg: svo.StereoVoConfig, K, height: int, width: int,
                 seed: int = 0, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self._step, self._boot = make_step(cfg, K)
        self.state = svo.init_state(cfg, height, width, seed, self.device)
        self._first = True
        self.metrics = {}

    def process(self, gray, depth) -> bool:
        g = torch.as_tensor(gray, device=self.device)
        d = torch.as_tensor(depth, device=self.device)
        if self._first:
            self.state = self._boot(self.state, g, d)
            self._first = False
            return True
        self.state, m = self._step(self.state, g, d)
        vals = torch.stack([v.to(torch.int64) for v in m.values()]).tolist()
        self.metrics = dict(zip(m.keys(), vals))     # one host sync
        return bool(self.metrics["pose_ok"])

    def camera_to_world(self):
        """Current camera->world SE3 as numpy (R, t)."""
        R, t = se3.invert(self.state.R, self.state.t)
        return R.cpu().numpy(), t.cpu().numpy()
