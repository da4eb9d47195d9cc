"""Monocular plane-based visual odometry (port of
``boofcv_tpu/sfm/mono_plane_vo.py``).

Reference analog: boofcv-sfm alg/sfm/d3/VisOdomMonoPlaneInfinity.java /
VisOdomMonoOverheadMotion2D.java — a monocular camera with known
extrinsics relative to a ground plane recovers metric motion from features
on that plane.

KLT tracks frame to frame (``klt_track`` on the card), a robust homography
is fit to the tracks, and Faugeras' decomposition with the known plane
normal and camera height turns it into metric (R, t) on the host.  A frame
reads the host once: the homography with its inlier count.
"""

from __future__ import annotations

import numpy as np
import torch

from boofcv_tpu_torch._config import resolve_device
from boofcv_tpu_torch.core.pyramid import PyramidConfig
from boofcv_tpu_torch.feature import extract, klt
from boofcv_tpu_torch.geo import robust, selfcalib
from boofcv_tpu_torch.ip import pyramid_ops
from boofcv_tpu_torch.sfm import stereo_vo as svo


class MonoPlaneVisualOdometry:
    """Host front end.  plane_normal: unit normal of the ground plane in the
    camera frame; plane_distance: camera height above the plane.  Runs on
    ``device`` (None: the card; raises without one)."""

    def __init__(self, K, plane_normal, plane_distance: float,
                 num_tracks: int = 300, scales=(1, 2, 4), seed: int = 0,
                 device=None):
        self.K = np.asarray(K, np.float64)
        self.n = np.asarray(plane_normal, np.float64)
        self.n /= np.linalg.norm(self.n)
        self.d = float(plane_distance)
        self.scales = tuple(scales)
        self.num_tracks = num_tracks
        self.device = resolve_device(device)
        self.rng = svo._generator(self.device, seed)
        self.cfg = klt.KltConfig(template_radius=3)
        self.R_cw = np.eye(3)   # world->camera
        self.t_cw = np.zeros(3)
        self._tracks = None
        self._tmpl = None

    def _retrack(self, img, pyr):
        """Fresh detections and their templates on this frame."""
        ys, xs, valid = extract.detect_tracks(img,
                                              max_features=self.num_tracks)
        self._tmpl = klt.sample_templates(pyr, pyramid_ops.gradient(pyr), ys,
                                          xs, self.scales,
                                          self.cfg.template_radius)
        self._tracks = (ys, xs, valid)

    def process(self, image) -> bool:
        img = torch.as_tensor(image, dtype=torch.float32, device=self.device)
        pyr = pyramid_ops.pyramid_average(img, PyramidConfig(self.scales))
        if self._tracks is None:
            self._retrack(img, pyr)
            return True

        ys, xs, valid = self._tracks
        nys, nxs, fault = klt.track_pyramid(pyr, self._tmpl, ys, xs,
                                            self.scales, self.cfg)
        ok = valid & (fault == klt.TRACK_OK)
        p1 = torch.stack([xs, ys], dim=-1).to(torch.float64)
        p2 = torch.stack([nxs, nys], dim=-1).to(torch.float64)
        res = robust.ransac_homography(self.rng, p1, p2, num_hypotheses=256,
                                       inlier_threshold_px=2.0,
                                       valid_mask=ok)
        # the frame's one host read: H and its inlier count together
        host = torch.cat([res.model.reshape(9),
                          res.num_inliers.reshape(1).to(torch.float64)]
                         ).cpu().numpy()
        if host[9] < 10:
            return False
        sols = selfcalib.homography_decompose(host[:9].reshape(3, 3), self.K,
                                              self.K)
        # the solution whose normal matches the known one; the decomposition
        # turns every normal to n[2] >= 0 (t with it), so compare |n . n0|
        # and re-align the sign after (a signed max picks a spurious
        # Faugeras solution when the true normal has negative z)
        R_rel, t_over_d, n_est = max(sols,
                                     key=lambda s: abs(float(s[2] @ self.n)))
        if float(n_est @ self.n) < 0:
            t_over_d = -t_over_d
        # accumulate: world->current = relative o world->previous
        self.R_cw = R_rel @ self.R_cw
        self.t_cw = R_rel @ self.t_cw + t_over_d * self.d
        self._retrack(img, pyr)
        return True

    def camera_to_world(self):
        return self.R_cw.T, -self.R_cw.T @ self.t_cw
