"""Dual-tracker stereo visual odometry (port of
``boofcv_tpu/sfm/dual_track_vo.py``).

Reference analog: boofcv-sfm alg/sfm/d3/VisOdomDualTrackPnP.java:57,181 —
independent point trackers in the left and right cameras; tracks are
paired stereo-wise at spawn, cross-checked with the epipolar constraint
every frame, and motion comes from RANSAC-PnP on the left camera's
observations of the triangulated points.

One fixed-capacity pool carries both cameras' tracks.  A step is two KLT
calls (two ``klt_track`` launches on the card), the row/disparity
cross-check, RANSAC-P3P, and, when the pool runs low, a spawn whose sparse
stereo runs the ``window_gather`` kernel twice.  One host sync a step
decides the spawn; RANSAC draws from a ``torch.Generator`` in the state,
forked every step as in ``stereo_vo``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from boofcv_tpu_torch._config import resolve_device
from boofcv_tpu_torch.core.pyramid import PyramidConfig
from boofcv_tpu_torch.feature import disparity as disp_mod
from boofcv_tpu_torch.feature import extract, intensity, klt
from boofcv_tpu_torch.geo import robust, se3
from boofcv_tpu_torch.geo.rectify import pixel_to_3d_rectified
from boofcv_tpu_torch.ip import pyramid_ops
from boofcv_tpu_torch.sfm import stereo_vo as svo


@dataclass(frozen=True)
class DualTrackVoConfig:
    num_tracks: int = 512
    pyramid_scales: tuple = (1, 2, 4, 8)
    template_radius: int = 3
    detect_radius: int = 5
    detect_threshold: float = 1.0
    max_disparity: int = 96
    disparity_radius: int = 3
    epipolar_tol_px: float = 1.5      # row tolerance of the L/R cross-check
    ransac_hypotheses: int = 256
    inlier_threshold_px: float = 1.5
    refine_iterations: int = 10
    respawn_below: float = 0.6
    klt: klt.KltConfig = klt.KltConfig()


class DualTrackVoState(NamedTuple):
    lxs: torch.Tensor        # [N] f32 left-camera track x
    lys: torch.Tensor
    rxs: torch.Tensor        # [N] f32 right-camera track x (same feature)
    rys: torch.Tensor
    world: torch.Tensor      # [N, 3] f64
    alive: torch.Tensor      # [N] bool
    tmpl_l: klt.KltTemplates
    tmpl_r: klt.KltTemplates
    R: torch.Tensor          # [3, 3] f64 world->left camera
    t: torch.Tensor          # [3] f64
    rng: torch.Generator     # RANSAC draws, forked by every step


_FIELDS = {"lxs": torch.float32, "lys": torch.float32, "rxs": torch.float32,
           "rys": torch.float32, "world": torch.float64, "alive": torch.bool,
           "R": torch.float64, "t": torch.float64}
_TEMPLATES = ("tmpl_l", "tmpl_r")


def init_state(cfg: DualTrackVoConfig, seed: int = 0,
               device=None) -> DualTrackVoState:
    """An empty pool on ``device`` (None: the card; raises without one)."""
    n = cfg.num_tracks
    p = 2 * cfg.template_radius + 1
    dev = resolve_device(device)
    zt = tuple(torch.zeros((n, p, p), dtype=torch.float32, device=dev)
               for _ in cfg.pyramid_scales)
    z = torch.zeros((n,), dtype=torch.float32, device=dev)
    return DualTrackVoState(
        z, z, z, z, torch.zeros((n, 3), dtype=torch.float64, device=dev),
        torch.zeros((n,), dtype=torch.bool, device=dev),
        klt.KltTemplates(zt, zt, zt), klt.KltTemplates(zt, zt, zt),
        torch.eye(3, dtype=torch.float64, device=dev),
        torch.zeros((3,), dtype=torch.float64, device=dev),
        svo._generator(dev, seed))


def state_from_numpy(d: dict, device=None) -> DualTrackVoState:
    """The port's state from numpy arrays named like the reference's
    ``DualTrackVoState`` fields (each template set a dict of per-level
    lists ``desc`` / ``grad_x`` / ``grad_y``).  ``key`` maps to a seed; an
    ``rng_state`` entry (from :func:`state_to_numpy`) restores the
    generator exactly.  ``device`` None means the card."""
    dev = resolve_device(device)
    f = lambda a, dtype: torch.as_tensor(np.array(a), dtype=dtype, device=dev)
    tm = lambda t: klt.KltTemplates(*(
        tuple(f(a, torch.float32) for a in t[k])
        for k in klt.KltTemplates._fields))
    rng = svo._generator_from_numpy(d["key"], d.get("rng_state"), dev)
    return DualTrackVoState(
        **{k: f(d[k], dt) for k, dt in _FIELDS.items()},
        **{k: tm(d[k]) for k in _TEMPLATES}, rng=rng)


def state_to_numpy(state: DualTrackVoState) -> dict:
    """The inverse of :func:`state_from_numpy`."""
    a = lambda x: x.detach().cpu().numpy()
    out = {k: a(getattr(state, k)) for k in _FIELDS}
    out.update({k: {f: [a(x) for x in getattr(getattr(state, k), f)]
                    for f in klt.KltTemplates._fields} for k in _TEMPLATES})
    out["key"] = svo._seed_key(state.rng)
    out["rng_state"] = state.rng.get_state().numpy()
    return out


def _spawn(state: DualTrackVoState, pyr_l, grads_l, pyr_r, grads_r, left,
           right, rectK, baseline, cfg: DualTrackVoConfig):
    """Detect in the left image, stereo-match with sparse BM, fill dead
    slots with the validated pairs (addNewTracks :181ff)."""
    n = cfg.num_tracks
    det = extract.detect(intensity.shi_tomasi(left, radius=2),
                         max_features=n, radius=cfg.detect_radius,
                         threshold=cfg.detect_threshold,
                         border=cfg.template_radius
                         * cfg.pyramid_scales[-1] + 2)
    cand_y = det.ys.to(torch.float32)
    cand_x = det.xs.to(torch.float32)
    cand_ok = det.valid & ~extract.near_live(cand_x, cand_y, state.lxs,
                                             state.lys, state.alive,
                                             cfg.detect_radius)
    dcfg = disp_mod.DisparityConfig(
        min_disparity=0, max_disparity=cfg.max_disparity,
        radius_x=cfg.disparity_radius, radius_y=cfg.disparity_radius,
        texture_threshold=0.1)
    disp, dvalid = disp_mod.sparse_block_match(left, right, det.ys, det.xs,
                                               dcfg)
    cand_ok = cand_ok & dvalid & (disp > 0.5)

    Xc = pixel_to_3d_rectified(cand_x.to(torch.float64),
                               cand_y.to(torch.float64),
                               disp.to(torch.float64), rectK, baseline)
    Rinv, tinv = se3.invert(state.R, state.t)
    Xw = Xc @ Rinv.transpose(-1, -2) + tinv[..., None, :]

    take, src, _ = svo._compact(state.alive, cand_ok)
    at = lambda a: a.gather(-1, src)
    lxs = torch.where(take, at(cand_x), state.lxs)
    lys = torch.where(take, at(cand_y), state.lys)
    rxs = torch.where(take, at(cand_x) - at(disp), state.rxs)
    rys = torch.where(take, at(cand_y), state.rys)
    world = torch.where(take[..., None],
                        Xw.gather(-2, src[..., None].expand(Xw.shape)),
                        state.world)
    tl = klt.sample_templates(pyr_l, grads_l, lys, lxs, cfg.pyramid_scales,
                              cfg.template_radius)
    tr = klt.sample_templates(pyr_r, grads_r, rys, rxs, cfg.pyramid_scales,
                              cfg.template_radius)
    return state._replace(
        lxs=lxs, lys=lys, rxs=rxs, rys=rys, world=world,
        alive=state.alive | take,
        tmpl_l=svo._mix_templates(take, tl, state.tmpl_l),
        tmpl_r=svo._mix_templates(take, tr, state.tmpl_r))


def _pyramids(left, right, pyr_cfg):
    left = left.to(torch.float32)
    right = right.to(torch.float32)
    return (left, right, pyramid_ops.pyramid_average(left, pyr_cfg),
            pyramid_ops.pyramid_average(right, pyr_cfg))


def make_step(cfg: DualTrackVoConfig, rectK, baseline: float):
    """step(state, left, right) -> (state, metrics) on the rectified pair
    (tensors on the state's device)."""
    rectK = np.asarray(rectK, np.float64)
    fx = float(rectK[0, 0])
    fy = float(rectK[1, 1])
    cx = float(rectK[0, 2])
    cy = float(rectK[1, 2])
    norm_thresh = (cfg.inlier_threshold_px / fx) ** 2
    pyr_cfg = PyramidConfig(scales=cfg.pyramid_scales)
    rect_k = svo._rect_k_on(rectK)

    def step(state: DualTrackVoState, left, right):
        left, right, pyr_l, pyr_r = _pyramids(left, right, pyr_cfg)
        # 1. both trackers advance independently
        nlys, nlxs, fl = klt.track_pyramid(pyr_l, state.tmpl_l, state.lys,
                                           state.lxs, cfg.pyramid_scales,
                                           cfg.klt)
        nrys, nrxs, fr = klt.track_pyramid(pyr_r, state.tmpl_r, state.rys,
                                           state.rxs, cfg.pyramid_scales,
                                           cfg.klt)
        # 2. stereo cross-check: a pair stays on its rectified row with a
        # positive bounded disparity
        disp = nlxs - nrxs
        tracked = (state.alive & (fl == klt.TRACK_OK) & (fr == klt.TRACK_OK)
                   & (torch.abs(nlys - nrys) <= cfg.epipolar_tol_px)
                   & (disp > 0.1) & (disp < cfg.max_disparity))
        lxs = torch.where(tracked, nlxs, state.lxs)
        lys = torch.where(tracked, nlys, state.lys)
        rxs = torch.where(tracked, nrxs, state.rxs)
        rys = torch.where(tracked, nrys, state.rys)

        # 3. motion from the left camera's observations
        obs = torch.stack([(lxs - cx) / fx, (lys - cy) / fy],
                          dim=-1).to(torch.float64)
        rng = svo._fork(state.rng)
        res, (Rn, tn) = robust.ransac_pnp(
            rng, state.world, obs, num_hypotheses=cfg.ransac_hypotheses,
            inlier_threshold=norm_thresh, valid_mask=tracked,
            refine_iterations=cfg.refine_iterations)
        ok = res.num_inliers >= 6
        Rn = torch.where(ok, Rn, state.R)
        tn = torch.where(ok, tn, state.t)
        # prune only on an accepted pose (a failed RANSAC's mask is junk)
        alive = tracked & (res.inliers | ~ok)
        new_state = state._replace(lxs=lxs, lys=lys, rxs=rxs, rys=rys,
                                   alive=alive, R=Rn, t=tn, rng=rng)
        # the step's one host sync: spawn when the pool runs low
        if bool(torch.mean(alive.to(torch.float32)) < cfg.respawn_below):
            new_state = _spawn(new_state, pyr_l, pyramid_ops.gradient(pyr_l),
                               pyr_r, pyramid_ops.gradient(pyr_r), left,
                               right, rect_k(left.device), baseline, cfg)
        return new_state, {"tracked": torch.sum(tracked),
                           "inliers": res.num_inliers,
                           "alive": torch.sum(new_state.alive),
                           "pose_ok": ok}

    return step


def make_bootstrap(cfg: DualTrackVoConfig, rectK, baseline: float):
    """boot(state, left, right) -> state: the first pair fills the pool."""
    pyr_cfg = PyramidConfig(scales=cfg.pyramid_scales)
    rect_k = svo._rect_k_on(rectK)

    def boot(state: DualTrackVoState, left, right):
        left, right, pyr_l, pyr_r = _pyramids(left, right, pyr_cfg)
        return _spawn(state, pyr_l, pyramid_ops.gradient(pyr_l), pyr_r,
                      pyramid_ops.gradient(pyr_r), left, right,
                      rect_k(left.device), baseline, cfg)

    return boot


class DualTrackVisualOdometry:
    """Host front end (abst StereoVisualOdometry analog, dual-tracker method):
    owns the state on ``device`` (None: the card; raises without one)."""

    def __init__(self, cfg: DualTrackVoConfig, rectK, baseline: float,
                 seed: int = 0, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self._step = make_step(cfg, rectK, float(baseline))
        self._boot = make_bootstrap(cfg, rectK, float(baseline))
        self.state = init_state(cfg, seed, self.device)
        self._first = True
        self.metrics = {}

    def process(self, left, right) -> bool:
        left = torch.as_tensor(left, device=self.device)
        right = torch.as_tensor(right, device=self.device)
        if self._first:
            self.state = self._boot(self.state, left, right)
            self._first = False
            return True
        self.state, m = self._step(self.state, left, right)
        vals = torch.stack([v.to(torch.int64) for v in m.values()]).tolist()
        self.metrics = dict(zip(m.keys(), vals))     # one host sync
        return bool(self.metrics["pose_ok"])

    def camera_to_world(self):
        """Current camera->world SE3 as numpy (R, t)."""
        R, t = se3.invert(self.state.R, self.state.t)
        return R.cpu().numpy(), t.cpu().numpy()
