"""2-D image stitching / video mosaic (port of ``boofcv_tpu/sfm/stitch2d.py``).

Reference analog: boofcv-sfm alg/sfm/d2/StitchingFromMotion2D.java
(incremental mosaic from tracked 2-D motion) and
ImageMotionPointTrackerKey.java (tracker + robust model fit).

KLT tracks frame to frame (``klt_track`` on the card, 20 iterations a
level), a robust homography accumulates into the mosaic-from-frame
transform on the host, and each frame is inverse-warped with one bilinear
lookup and averaged into the mosaic canvas on the device.  A frame reads
the host once, after RANSAC (the model, its inlier count and the two track
counts of the re-detect decision, which the reference reads in four
transfers), and uploads the inverse warp once.
"""

from __future__ import annotations

import numpy as np
import torch

from boofcv_tpu_torch._config import resolve_device
from boofcv_tpu_torch.core.pyramid import PyramidConfig
from boofcv_tpu_torch.feature import extract, klt
from boofcv_tpu_torch.geo import robust
from boofcv_tpu_torch.ip import pyramid_ops
from boofcv_tpu_torch.ip.interpolate import bilinear
from boofcv_tpu_torch.sfm import stereo_vo as svo


class Stitcher:
    """Host front end (StitchingFromMotion2D analog) on ``device`` (None: the
    card; raises without one)."""

    def __init__(self, mosaic_h: int, mosaic_w: int, offset=(0.0, 0.0),
                 num_tracks: int = 300, scales=(1, 2, 4),
                 ransac_hypotheses: int = 256, inlier_px: float = 2.0,
                 retrack_below: float = 0.5, seed: int = 0, device=None):
        self.device = resolve_device(device)
        self.shape = (mosaic_h, mosaic_w)
        self.offset = np.asarray(offset)   # where frame 0's origin lands
        self.scales = tuple(scales)
        self.n = num_tracks
        self.rng = svo._generator(self.device, seed)
        self.hyp = ransac_hypotheses
        self.inlier_px = inlier_px
        self.retrack_below = retrack_below
        self.cfg = klt.KltConfig(template_radius=3, max_iterations=20)
        self.H_mosaic_from_frame = np.eye(3)
        self.mosaic = torch.zeros(self.shape, dtype=torch.float32,
                                  device=self.device)
        self.weight = torch.zeros_like(self.mosaic)
        ys, xs = torch.meshgrid(
            torch.arange(mosaic_h, dtype=torch.float32, device=self.device),
            torch.arange(mosaic_w, dtype=torch.float32, device=self.device),
            indexing="ij")
        self._grid = torch.stack([xs, ys, torch.ones_like(xs)], dim=-1)
        self._prev = None
        self._tracks = None

    def _detect(self, image):
        return extract.detect_tracks(image, max_features=self.n)

    def _track(self, pyr_prev, pyr_cur, ys, xs):
        tmpl = klt.sample_templates(pyr_prev, pyramid_ops.gradient(pyr_prev),
                                    ys, xs, self.scales,
                                    self.cfg.template_radius)
        nys, nxs, fault = klt.track_pyramid(pyr_cur, tmpl, ys, xs,
                                            self.scales, self.cfg)
        return nys, nxs, fault == klt.TRACK_OK

    def _blend(self, image, H_frame_to_mosaic):
        """Warp the frame into the mosaic canvas and add it to the
        average."""
        Hm = torch.as_tensor(np.linalg.inv(H_frame_to_mosaic),
                             dtype=torch.float32, device=self.device)
        pts = self._grid @ Hm.T
        z = pts[..., 2]
        z = torch.where(torch.abs(z) < 1e-9, 1e-9, z)
        fx = pts[..., 0] / z
        fy = pts[..., 1] / z
        ih, iw = image.shape
        inb = (fx >= 0) & (fx <= iw - 1) & (fy >= 0) & (fy <= ih - 1)
        self.mosaic = self.mosaic + torch.where(inb, bilinear(image, fy, fx),
                                                0.0)
        self.weight = self.weight + inb.to(torch.float32)

    def process(self, image) -> bool:
        image = torch.as_tensor(image, dtype=torch.float32,
                                device=self.device)
        pyr = pyramid_ops.pyramid_average(image, PyramidConfig(self.scales))
        if self._prev is None:
            T = np.eye(3)
            T[0, 2], T[1, 2] = self.offset
            self.H_mosaic_from_frame = T
            self._blend(image, T)
            self._tracks = self._detect(image)
            self._prev = pyr
            return True

        ys, xs, valid = self._tracks
        nys, nxs, ok = self._track(self._prev, pyr, ys, xs)
        ok = ok & valid
        res = robust.ransac_homography(
            self.rng, torch.stack([xs, ys], dim=-1).to(torch.float64),
            torch.stack([nxs, nys], dim=-1).to(torch.float64),
            num_hypotheses=self.hyp, inlier_threshold_px=self.inlier_px,
            valid_mask=ok)
        kept = ok & res.inliers
        # the frame's one host read
        host = torch.cat([res.model.reshape(9),
                          torch.stack([res.num_inliers, torch.sum(valid),
                                       torch.sum(kept)]).to(torch.float64)]
                         ).cpu().numpy()
        n_inliers, n_valid, n_kept = host[9:]
        if n_inliers < 8:
            return False
        self.H_mosaic_from_frame = (self.H_mosaic_from_frame
                                    @ np.linalg.inv(host[:9].reshape(3, 3)))
        self._blend(image, self.H_mosaic_from_frame)

        # the share of ever-valid tracks still inlying (a mean over the
        # capacity would re-detect every frame in a feature-sparse scene)
        if n_kept / max(n_valid, 1.0) < self.retrack_below:
            self._tracks = self._detect(image)
        else:
            self._tracks = (nys, nxs, kept)
        self._prev = pyr
        return True

    def image(self):
        """The mosaic as numpy: the average of every frame over each
        pixel."""
        return (self.mosaic / torch.clamp(self.weight, min=1.0)).cpu().numpy()
