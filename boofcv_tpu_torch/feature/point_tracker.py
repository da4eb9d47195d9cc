"""Point-tracker interface and implementations (port of
``boofcv_tpu/feature/point_tracker.py``).

Reference analog: boofcv-geo abst/feature/tracker/ — PointTracker.java:60
(process / spawn / active tracks), PointTrackerKltPyramid.java:41,
DetectDescribeAssociate.java:42, the combined KLT + re-detection hybrid
(CombinedTrackerScalePoint) and PointTrackerTwoPass.java.

Each tracker owns a fixed-capacity pool: positions and the alive mask on
the device for the KLT trackers (``klt_track`` on the card), numpy for the
detect-describe-associate tracker; uids are numpy on the host, and the
slot-filling loops run on the host, as in the reference.  A KLT tracker's
``process`` reads the host once to skip an empty pool
(``bool(torch.any(alive))``).  ``load_pool`` puts a pool from numpy
(positions, alive, uids, templates or descriptors) into a tracker, so two
trackers can start from the same state.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from boofcv_tpu_torch._config import resolve_device
from boofcv_tpu_torch.core.pyramid import PyramidConfig
from boofcv_tpu_torch.feature import (associate, describe, extract,
                                      fasthessian, intensity, klt)
from boofcv_tpu_torch.ip import integral as ii_ops
from boofcv_tpu_torch.ip import pyramid_ops


@dataclass
class Track:
    uid: int
    x: float
    y: float


class PointTracker:
    """Interface (PointTracker.java): process -> active tracks; spawn."""

    def process(self, image) -> None:
        raise NotImplementedError

    def spawn(self) -> None:
        raise NotImplementedError

    def active_tracks(self) -> list:
        raise NotImplementedError


def _surf_frame(ii: torch.Tensor, per_octave: int):
    """Fast-Hessian over the octaves, Haar orientation and SURF-64 on an
    integral image: (detections, descriptors [N, 64])."""
    det = fasthessian.detect_multi_octave(
        ii, max_features_per_octave=per_octave)
    ang = describe.orientation_average_haar(ii, det.ys, det.xs, det.scales)
    return det, describe.surf(ii, det.ys, det.xs, det.scales, ang)


def _host(*tensors):
    """Tensors as numpy arrays (a host read each on the card)."""
    return [t.detach().cpu().numpy() for t in tensors]


class PointTrackerKlt(PointTracker):
    """Pyramidal KLT point tracker (PointTrackerKltPyramid analog) on
    ``device`` (None: the card; raises without one)."""

    def __init__(self, max_tracks: int = 400, scales=(1, 2, 4),
                 template_radius: int = 3, detect_radius: int = 5,
                 device=None):
        self.n = max_tracks
        self.scales = tuple(scales)
        self.cfg = klt.KltConfig(template_radius=template_radius)
        self.detect_radius = detect_radius
        self.device = resolve_device(device)
        self.xs = torch.zeros((max_tracks,), dtype=torch.float32,
                              device=self.device)
        self.ys = torch.zeros_like(self.xs)
        self.alive = torch.zeros((max_tracks,), dtype=torch.bool,
                                 device=self.device)
        self.uid = np.full(max_tracks, -1, np.int64)
        self._next_uid = 0
        self._pyr = None
        self._tmpl = None

    def _pyramid(self, image):
        img = torch.as_tensor(image, dtype=torch.float32, device=self.device)
        return pyramid_ops.pyramid_average(img, PyramidConfig(self.scales))

    def _sample_templates(self):
        """Templates of every slot on the current pyramid."""
        self._tmpl = klt.sample_templates(
            self._pyr, pyramid_ops.gradient(self._pyr), self.ys, self.xs,
            self.scales, self.cfg.template_radius)

    def load_pool(self, pool: dict, image=None) -> None:
        """Put a pool from numpy into the tracker: ``xs``, ``ys``,
        ``alive``, ``uid`` [N], ``next_uid``, and ``templates`` (a dict of
        per-level lists ``desc`` / ``grad_x`` / ``grad_y``), taken on
        ``image``, which becomes the previous frame."""
        f = lambda a, dt: torch.as_tensor(np.array(a), dtype=dt,
                                          device=self.device)
        self.xs = f(pool["xs"], torch.float32)
        self.ys = f(pool["ys"], torch.float32)
        self.alive = f(pool["alive"], torch.bool)
        self.uid = np.array(pool["uid"], np.int64)
        self._next_uid = int(pool["next_uid"])
        tm = pool["templates"]
        self._tmpl = klt.KltTemplates(*(
            tuple(f(a, torch.float32) for a in tm[k])
            for k in klt.KltTemplates._fields))
        if image is not None:
            self._pyr = self._pyramid(image)

    def process(self, image) -> None:
        pyr = self._pyramid(image)
        # one host read a frame: an empty pool is not tracked
        if self._pyr is not None and bool(torch.any(self.alive)):
            nys, nxs, fault = klt.track_pyramid(
                pyr, self._tmpl, self.ys, self.xs, self.scales, self.cfg)
            ok = self.alive & (fault == klt.TRACK_OK)
            self.xs = torch.where(ok, nxs, self.xs)
            self.ys = torch.where(ok, nys, self.ys)
            self.alive = ok
        self._pyr = pyr

    def spawn(self) -> None:
        if self._pyr is None:
            return
        det = extract.detect(intensity.shi_tomasi(self._pyr[0], radius=2),
                             max_features=self.n, radius=self.detect_radius,
                             threshold=1.0,
                             border=self.cfg.template_radius
                             * self.scales[-1] + 2)
        cy = det.ys.to(torch.float32)
        cx = det.xs.to(torch.float32)
        ok = det.valid & ~extract.near_live(cx, cy, self.xs, self.ys,
                                            self.alive, self.detect_radius)
        # host-side fill of dead slots (spawn runs rarely)
        ok_np, alive = _host(ok, self.alive)
        cy_np, cx_np, xs, ys = _host(cy, cx, self.xs, self.ys)
        dead = np.nonzero(~alive)[0]
        cands = np.nonzero(ok_np)[0]
        take = min(len(dead), len(cands))
        for s, c in zip(dead[:take], cands[:take]):
            xs[s] = cx_np[c]
            ys[s] = cy_np[c]
            alive[s] = True
            self.uid[s] = self._next_uid
            self._next_uid += 1
        self._upload(xs, ys, alive)
        self._sample_templates()

    def _upload(self, xs, ys, alive):
        self.xs = torch.as_tensor(xs, device=self.device)
        self.ys = torch.as_tensor(ys, device=self.device)
        self.alive = torch.as_tensor(alive, device=self.device)

    def active_tracks(self) -> list:
        alive, xs, ys = _host(self.alive, self.xs, self.ys)
        return [Track(int(self.uid[i]), float(xs[i]), float(ys[i]))
                for i in np.nonzero(alive)[0]]


class PointTrackerDda(PointTracker):
    """Detect-describe-associate tracker (DetectDescribeAssociate analog):
    SURF detect + describe each frame on ``device`` (None: the card), and
    mutual-NN association to the pool's descriptors; the pool is numpy on
    the host."""

    def __init__(self, max_tracks: int = 300, max_error: float = 0.4,
                 device=None):
        self.n = max_tracks
        self.max_error = max_error
        self.device = resolve_device(device)
        self.desc = None          # [N, 64]
        self.xs = np.zeros(max_tracks)
        self.ys = np.zeros(max_tracks)
        self.alive = np.zeros(max_tracks, bool)
        self.uid = np.full(max_tracks, -1, np.int64)
        self._next_uid = 0
        self._frame = None

    def load_pool(self, pool: dict) -> None:
        """Put a pool from numpy into the tracker: ``xs``, ``ys``,
        ``alive``, ``uid`` [N], ``next_uid`` and ``desc`` [N, 64]."""
        self.xs = np.array(pool["xs"], np.float64)
        self.ys = np.array(pool["ys"], np.float64)
        self.alive = np.array(pool["alive"], bool)
        self.uid = np.array(pool["uid"], np.int64)
        self._next_uid = int(pool["next_uid"])
        self.desc = np.array(pool["desc"], np.float32)

    def _detect(self, image):
        ii = ii_ops.transform(torch.as_tensor(image, dtype=torch.float32,
                                              device=self.device))
        det, d = _surf_frame(ii, self.n // 2)
        ys, xs, d, v = _host(det.ys, det.xs, d, det.valid)
        return ys[v], xs[v], d[v]

    def process(self, image) -> None:
        ys, xs, desc = self._detect(image)
        self._frame = (ys, xs, desc)
        if self.desc is None or not self.alive.any():
            return
        pool = torch.as_tensor(self.desc[self.alive], dtype=torch.float32,
                               device=self.device)
        scores = associate.score_euclidean_sq(
            pool, torch.as_tensor(desc, dtype=torch.float32,
                                  device=self.device))
        m = associate.associate_mutual(scores, max_error=self.max_error ** 2)
        src, dst, mv = _host(m.src, m.dst, m.valid)
        alive_idx = np.nonzero(self.alive)[0]
        new_alive = np.zeros_like(self.alive)
        for s, d_, v in zip(src, dst, mv):
            if not v:
                continue
            slot = alive_idx[s]
            self.xs[slot] = xs[d_]
            self.ys[slot] = ys[d_]
            self.desc[slot] = desc[d_]
            new_alive[slot] = True
        self.alive = new_alive

    def spawn(self) -> None:
        if self._frame is None:
            return
        ys, xs, desc = self._frame
        if self.desc is None:
            self.desc = np.zeros((self.n, desc.shape[1]), np.float32)
        dead = np.nonzero(~self.alive)[0]
        live = np.nonzero(self.alive)[0]      # do not duplicate live tracks
        for i in range(len(ys)):
            if len(dead) == 0:
                break
            if live.size:
                d2 = ((self.xs[live] - xs[i]) ** 2
                      + (self.ys[live] - ys[i]) ** 2)
                if d2.min() < 25.0:
                    continue
            s, dead = dead[0], dead[1:]
            self.xs[s] = xs[i]
            self.ys[s] = ys[i]
            self.desc[s] = desc[i]
            self.alive[s] = True
            self.uid[s] = self._next_uid
            self._next_uid += 1

    def active_tracks(self) -> list:
        return [Track(int(self.uid[i]), float(self.xs[i]), float(self.ys[i]))
                for i in np.nonzero(self.alive)[0]]


class PointTrackerCombined(PointTrackerKlt):
    """KLT + detect-describe re-association (CombinedTrackerScalePoint
    analog): KLT carries the frame-to-frame motion; tracks the KLT drops
    are re-acquired by matching their spawn-time SURF descriptors against
    the current frame's detections."""

    def __init__(self, max_tracks: int = 400, scales=(1, 2, 4),
                 template_radius: int = 3, detect_radius: int = 5,
                 reassociate_error: float = 0.35, device=None):
        super().__init__(max_tracks, scales, template_radius, detect_radius,
                         device)
        self.desc = np.zeros((max_tracks, 64), np.float32)
        self.has_desc = np.zeros(max_tracks, bool)
        self.max_error = reassociate_error

    def load_pool(self, pool: dict, image=None) -> None:
        """As :meth:`PointTrackerKlt.load_pool`, with ``desc`` [N, 64] and
        ``has_desc`` [N]."""
        super().load_pool(pool, image)
        self.desc = np.array(pool["desc"], np.float32)
        self.has_desc = np.array(pool["has_desc"], bool)

    def process(self, image) -> None:
        was_alive = _host(self.alive)[0]
        super().process(image)
        lost = was_alive & ~_host(self.alive)[0] & self.has_desc
        if not lost.any():
            return
        # re-detection pass: describe the current frame, match lost tracks
        det, d = _surf_frame(ii_ops.transform(self._pyr[0]), self.n // 2)
        lost_idx = np.nonzero(lost)[0]
        scores = associate.score_euclidean_sq(
            torch.as_tensor(self.desc[lost_idx], device=self.device),
            d.to(torch.float32))
        m = associate.associate_mutual(scores, valid_b=det.valid,
                                       max_error=self.max_error ** 2)
        mv, dst, dy, dx = _host(m.valid, m.dst, det.ys, det.xs)
        xs, ys, alive = _host(self.xs, self.ys, self.alive)
        recovered = False
        for k, slot in enumerate(lost_idx):
            if not mv[k]:
                continue
            xs[slot] = dx[dst[k]]
            ys[slot] = dy[dst[k]]
            alive[slot] = True
            recovered = True
        if recovered:
            self._upload(xs, ys, alive)
            self._sample_templates()

    def spawn(self) -> None:
        """Spawn from Fast-Hessian detections, so that every track carries
        a scale-consistent SURF descriptor for a later re-association (the
        reference's combined tracker spawns from its DDA detector too)."""
        if self._pyr is None:
            return
        img = self._pyr[0]
        det, d = _surf_frame(ii_ops.transform(img), self.n // 2)
        d, dy, dx, dv = _host(d.to(torch.float32), det.ys, det.xs, det.valid)
        xs, ys, alive = _host(self.xs, self.ys, self.alive)
        h, w = img.shape
        b = self.cfg.template_radius * self.scales[-1] + 2
        dead = list(np.nonzero(~alive)[0])
        live = np.nonzero(alive)[0]
        for i in np.nonzero(dv)[0]:
            if not dead:
                break
            if not (b <= dy[i] < h - b and b <= dx[i] < w - b):
                continue
            if live.size:
                d2 = (xs[live] - dx[i]) ** 2 + (ys[live] - dy[i]) ** 2
                if d2.min() < (2 * self.detect_radius) ** 2:
                    continue
            s = dead.pop(0)
            xs[s] = dx[i]
            ys[s] = dy[i]
            alive[s] = True
            self.desc[s] = d[i]
            self.has_desc[s] = True
            self.uid[s] = self._next_uid
            self._next_uid += 1
        self._upload(xs, ys, alive)
        self._sample_templates()


class PointTrackerTwoPassKlt(PointTrackerKlt):
    """Two-pass KLT tracker (PointTrackerTwoPass.java +
    PointTrackerTwoPassKltPyramid): the first pass tracks from the previous
    positions; the caller (a VO) estimates motion from the provisional
    tracks and calls :meth:`second_pass` with predicted positions, which
    re-tracks from much better starting points; :meth:`finish` commits."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._pending = None      # (xs, ys, alive) awaiting finish()
        self._cur_pyr = None

    def process(self, image) -> None:
        pyr = self._pyramid(image)
        self._cur_pyr = pyr
        if self._pyr is not None and bool(torch.any(self.alive)):
            nys, nxs, fault = klt.track_pyramid(
                pyr, self._tmpl, self.ys, self.xs, self.scales, self.cfg)
            ok = self.alive & (fault == klt.TRACK_OK)
            self._pending = (torch.where(ok, nxs, self.xs),
                             torch.where(ok, nys, self.ys), ok)
        else:
            # first frame: nothing to track; commit at once so that spawn()
            # samples templates from it
            self._pyr = pyr
            self._pending = (self.xs, self.ys, self.alive)

    def second_pass(self, pred_ys, pred_xs) -> None:
        """Re-track every slot from the caller's predictions (e.g.
        reprojections through the estimated motion)."""
        if self._cur_pyr is None or self._tmpl is None:
            return
        nys, nxs, fault = klt.track_pyramid(
            self._cur_pyr, self._tmpl,
            torch.as_tensor(pred_ys, dtype=torch.float32, device=self.device),
            torch.as_tensor(pred_xs, dtype=torch.float32, device=self.device),
            self.scales, self.cfg)
        ok2 = self.alive & (fault == klt.TRACK_OK)
        xs1, ys1, ok1 = self._pending
        # the hinted pass replaces the first (the reference's
        # performSecondPass re-tracks everything from the predictions; a
        # first pass beyond the motion range converges to false minima, so
        # it survives only where the hinted pass fails)
        self._pending = (
            torch.where(ok2, nxs, torch.where(ok1, xs1, self.xs)),
            torch.where(ok2, nys, torch.where(ok1, ys1, self.ys)), ok1 | ok2)

    def finish(self) -> None:
        """Commit the (possibly second-pass-improved) track update."""
        self.xs, self.ys, self.alive = self._pending
        self._pyr = self._cur_pyr
        self._pending = None
