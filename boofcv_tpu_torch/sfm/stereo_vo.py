"""Stereo visual odometry: KLT tracking + sparse stereo depth + RANSAC P3P
(port of ``boofcv_tpu/sfm/stereo_vo.py``, single-stream path).

Reference analog: boofcv-sfm alg/sfm/d3/VisOdomPixelDepthPnP.java:56,154
(tracker.process -> estimateMotion [RANSAC P3P + refine] -> drop unused ->
addNewTracks [spawn + sparse stereo 3D]).

The per-frame step is eager PyTorch over a fixed-capacity track pool on
one device.  Its only device->host sync is the spawn decision (one Python
``if`` on the live fraction per frame); KLT and the GN refine run fixed
iteration counts with frozen flags instead of early exits.  RANSAC draws
from a ``torch.Generator`` carried in the state: each step forks it, so a
state is a value, as in the reference, and replaying a step from the same
state replays its draws.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, NamedTuple

import numpy as np
import torch

from boofcv_tpu_torch.core.pyramid import PyramidConfig
from boofcv_tpu_torch.feature import disparity as disp_mod
from boofcv_tpu_torch.feature import extract, intensity, klt
from boofcv_tpu_torch.geo import robust, se3
from boofcv_tpu_torch.geo.rectify import pixel_to_3d_rectified
from boofcv_tpu_torch.ip import pyramid_ops


@dataclass(frozen=True)
class StereoVoConfig:
    """FactoryVisualOdometry.stereoDepth config analog (the reference
    example workload)."""
    num_tracks: int = 512
    pyramid_scales: tuple = (1, 2, 4, 8)
    template_radius: int = 3
    detect_radius: int = 5
    detect_threshold: float = 1.0
    min_disparity: int = 0
    max_disparity: int = 96
    disparity_radius: int = 3
    ransac_hypotheses: int = 256
    inlier_threshold_px: float = 1.5
    refine_iterations: int = 10
    respawn_below: float = 0.6     # respawn when alive fraction drops below
    klt: klt.KltConfig = klt.KltConfig()


class StereoVoState(NamedTuple):
    """Fixed-capacity VO state on one device."""
    xs: torch.Tensor          # [N] f32 track x (rectified-left pixels)
    ys: torch.Tensor          # [N] f32
    world: torch.Tensor       # [N, 3] f64 points in the world frame
    alive: torch.Tensor       # [N] bool
    templates: klt.KltTemplates
    R: torch.Tensor           # [3, 3] f64 world->camera
    t: torch.Tensor           # [3] f64
    rng: torch.Generator      # RANSAC draws (forked by every step)
    uid: torch.Tensor         # [N] int32 stable track id
    next_uid: torch.Tensor    # scalar int32


def _generator(device, seed: int) -> torch.Generator:
    g = torch.Generator(device=torch.device(device))
    g.manual_seed(int(seed))
    return g


def _fork(g: torch.Generator) -> torch.Generator:
    """A copy of ``g`` at its current position (host-side state only)."""
    out = torch.Generator(device=g.device)
    out.set_state(g.get_state())
    return out


def init_state(cfg: StereoVoConfig, height: int, width: int, seed: int = 0,
               device="cpu") -> StereoVoState:
    n = cfg.num_tracks
    p = 2 * cfg.template_radius + 1
    dev = torch.device(device)
    zero_t = tuple(torch.zeros((n, p, p), dtype=torch.float32, device=dev)
                   for _ in cfg.pyramid_scales)
    return StereoVoState(
        xs=torch.zeros((n,), dtype=torch.float32, device=dev),
        ys=torch.zeros((n,), dtype=torch.float32, device=dev),
        world=torch.zeros((n, 3), dtype=torch.float64, device=dev),
        alive=torch.zeros((n,), dtype=torch.bool, device=dev),
        templates=klt.KltTemplates(zero_t, zero_t, zero_t),
        R=torch.eye(3, dtype=torch.float64, device=dev),
        t=torch.zeros((3,), dtype=torch.float64, device=dev),
        rng=_generator(dev, seed),
        uid=torch.full((n,), -1, dtype=torch.int32, device=dev),
        next_uid=torch.zeros((), dtype=torch.int32, device=dev))


def _key_to_seed(key) -> int:
    """The reference's PRNGKey(seed) holds [seed >> 32, seed & 0xffffffff]."""
    k = np.asarray(key).astype(np.uint64).ravel()
    return int((int(k[0]) << 32) | int(k[1]))


def state_from_numpy(d: dict, device="cpu") -> StereoVoState:
    """Build the port's state from numpy arrays named like the reference's
    ``StereoVoState`` fields (``templates`` as a dict of per-level lists
    ``desc`` / ``grad_x`` / ``grad_y``).  The reference's ``key`` maps to a
    seed and the generator is rebuilt from it; an ``rng_state`` entry
    (written by :func:`state_to_numpy`) restores the generator exactly."""
    dev = torch.device(device)

    def f(a, dtype):
        return torch.as_tensor(np.array(a), dtype=dtype, device=dev)

    tm = d["templates"]
    tl = lambda k: tuple(f(a, torch.float32) for a in tm[k])
    if "rng_state" in d:
        rng = torch.Generator(device=dev)
        rng.set_state(torch.as_tensor(np.array(d["rng_state"]),
                                   dtype=torch.uint8))
    else:
        rng = _generator(dev, _key_to_seed(d["key"]))
    return StereoVoState(
        xs=f(d["xs"], torch.float32), ys=f(d["ys"], torch.float32),
        world=f(d["world"], torch.float64), alive=f(d["alive"], torch.bool),
        templates=klt.KltTemplates(tl("desc"), tl("grad_x"), tl("grad_y")),
        R=f(d["R"], torch.float64), t=f(d["t"], torch.float64), rng=rng,
        uid=f(d["uid"], torch.int32), next_uid=f(d["next_uid"], torch.int32))


def state_to_numpy(state: StereoVoState) -> dict:
    """The inverse of :func:`state_from_numpy` (``key`` from the
    generator's seed, ``rng_state`` for its exact position)."""
    a = lambda x: x.detach().cpu().numpy()
    seed = state.rng.initial_seed()
    return {
        "xs": a(state.xs), "ys": a(state.ys), "world": a(state.world),
        "alive": a(state.alive),
        "templates": {k: [a(x) for x in getattr(state.templates, k)]
                      for k in ("desc", "grad_x", "grad_y")},
        "R": a(state.R), "t": a(state.t),
        "key": np.array([(seed >> 32) & 0xffffffff, seed & 0xffffffff],
                        np.uint32),
        "rng_state": state.rng.get_state().numpy(),
        "uid": a(state.uid), "next_uid": a(state.next_uid),
    }


def _detect_candidates(image, cfg: StereoVoConfig, n_cand: int):
    inten = intensity.shi_tomasi(image, radius=2)
    return extract.detect(inten, max_features=n_cand,
                          radius=cfg.detect_radius,
                          threshold=cfg.detect_threshold,
                          border=cfg.template_radius * cfg.pyramid_scales[-1]
                          + 2)


def _spawn(state: StereoVoState, pyramid, grads, left, right, rectK,
           baseline, cfg: StereoVoConfig) -> StereoVoState:
    """Fill dead slots with fresh detections + stereo depth (addNewTracks):
    detect, reject candidates near live tracks, sparse SAD disparity, lift
    to 3D in the world frame through the current pose."""
    n = cfg.num_tracks
    dev = left.device
    det = _detect_candidates(left, cfg, n)
    cand_y = det.ys.to(torch.float32)
    cand_x = det.xs.to(torch.float32)
    cand_ok = det.valid

    d2 = ((cand_x[:, None] - state.xs[None, :]) ** 2
          + (cand_y[:, None] - state.ys[None, :]) ** 2)
    d2 = torch.where(state.alive[None, :], d2, float("inf"))
    cand_ok = cand_ok & (torch.amin(d2, dim=1) > (2 * cfg.detect_radius) ** 2)

    dcfg = disp_mod.DisparityConfig(
        min_disparity=cfg.min_disparity, max_disparity=cfg.max_disparity,
        radius_x=cfg.disparity_radius, radius_y=cfg.disparity_radius,
        texture_threshold=0.1)
    disp, dvalid = disp_mod.sparse_block_match(left, right, det.ys, det.xs,
                                               dcfg)
    cand_ok = cand_ok & dvalid & (disp > 0.5)

    Xc = pixel_to_3d_rectified(cand_x.to(torch.float64),
                               cand_y.to(torch.float64),
                               disp.to(torch.float64), rectK, baseline)
    Rinv, tinv = se3.invert(state.R, state.t)
    Xw = Xc @ Rinv.T + tinv

    # compact candidates into dead slots by rank; duplicate writes land
    # only on rank 0, which is never read, so write order does not matter
    dead = ~state.alive
    slot_rank = torch.cumsum(dead.to(torch.int64), 0) * dead
    cand_rank = torch.cumsum(cand_ok.to(torch.int64), 0) * cand_ok
    by_rank = torch.zeros((n + 1,), dtype=torch.int64, device=dev)
    by_rank.index_put_((cand_rank,), torch.arange(n, device=dev))
    n_cand = torch.amax(cand_rank)
    take = dead & (slot_rank <= n_cand) & (slot_rank > 0)
    src = by_rank[torch.clamp(slot_rank, 0, n)]

    new_xs = torch.where(take, cand_x[src], state.xs)
    new_ys = torch.where(take, cand_y[src], state.ys)
    new_world = torch.where(take[:, None], Xw[src], state.world)
    new_alive = state.alive | take
    new_uid = torch.where(
        take, state.next_uid + slot_rank.to(torch.int32) - 1, state.uid)
    next_uid = state.next_uid + torch.amax(slot_rank * take).to(torch.int32)

    # templates at the new positions; existing tracks keep their
    # spawn-time templates (the reference's KLT never re-describes a track)
    tmpl_new = klt.sample_templates(pyramid, grads, new_ys, new_xs,
                                    cfg.pyramid_scales, cfg.template_radius)
    mix = lambda new, old: tuple(torch.where(take[:, None, None], a, b)
                                 for a, b in zip(new, old))
    tmpl = klt.KltTemplates(mix(tmpl_new.desc, state.templates.desc),
                            mix(tmpl_new.grad_x, state.templates.grad_x),
                            mix(tmpl_new.grad_y, state.templates.grad_y))
    return state._replace(xs=new_xs, ys=new_ys, world=new_world,
                          alive=new_alive, templates=tmpl,
                          uid=new_uid, next_uid=next_uid)


def _rect_k_on(rectK) -> Callable[[torch.device], torch.Tensor]:
    """device -> the intrinsics as a float64 tensor there, uploaded once per
    device (a host->device copy from numpy is a sync)."""
    rectK = np.asarray(rectK, np.float64)
    cache = {}

    def on(device):
        if device not in cache:
            cache[device] = torch.as_tensor(rectK, device=device)
        return cache[device]

    return on


def _make_step_parts(cfg: StereoVoConfig, rectK, baseline: float):
    """(track_estimate, spawn_fn): the two halves of the per-frame step."""
    rectK = np.asarray(rectK, np.float64)
    fx = float(rectK[0, 0])
    fy = float(rectK[1, 1])
    cx = float(rectK[0, 2])
    cy = float(rectK[1, 2])
    norm_thresh = (cfg.inlier_threshold_px / fx) ** 2
    pyr_cfg = PyramidConfig(scales=cfg.pyramid_scales)
    rect_k = _rect_k_on(rectK)

    def track_estimate(state: StereoVoState, left, right):
        left = left.to(torch.float32)
        pyramid = pyramid_ops.pyramid_average(left, pyr_cfg)

        # 1. track
        nys, nxs, fault = klt.track_pyramid(
            pyramid, state.templates, state.ys, state.xs,
            cfg.pyramid_scales, cfg.klt)
        tracked = state.alive & (fault == klt.TRACK_OK)
        xs = torch.where(tracked, nxs, state.xs)
        ys = torch.where(tracked, nys, state.ys)

        # 2. motion: RANSAC P3P on tracked points
        obs = torch.stack([(xs - cx) / fx, (ys - cy) / fy], dim=-1)
        rng = _fork(state.rng)
        res, (Rn, tn) = robust.ransac_pnp(
            rng, state.world, obs.to(torch.float64),
            num_hypotheses=cfg.ransac_hypotheses,
            inlier_threshold=norm_thresh, valid_mask=tracked,
            refine_iterations=cfg.refine_iterations)

        # too few inliers: keep the previous pose, and leave the tracks
        # alone (a failed RANSAC's inlier mask is from a junk hypothesis)
        ok = res.num_inliers >= 6
        Rn = torch.where(ok, Rn, state.R)
        tn = torch.where(ok, tn, state.t)
        alive = tracked & (res.inliers | ~ok)

        new_state = state._replace(xs=xs, ys=ys, alive=alive, R=Rn, t=tn,
                                   rng=rng)
        frac = torch.mean(alive.to(torch.float32))
        return (new_state, pyramid, left, right.to(torch.float32), frac,
                (torch.sum(tracked), res.num_inliers, ok))

    def spawn_fn(s, pyramid, left, right):
        grads = pyramid_ops.gradient(pyramid)
        return _spawn(s, pyramid, grads, left, right,
                      rect_k(left.device), baseline, cfg)

    return track_estimate, spawn_fn


def _make_step_fn(cfg: StereoVoConfig, rectK, baseline: float):
    track_estimate, spawn_fn = _make_step_parts(cfg, rectK, baseline)

    def step(state: StereoVoState, left, right):
        new_state, pyramid, l32, r32, frac, (n_tracked, n_inl, ok) = \
            track_estimate(state, left, right)
        # spawn into dead slots when the pool runs low: the step's one
        # device->host sync
        if bool(frac < cfg.respawn_below):
            new_state = spawn_fn(new_state, pyramid, l32, r32)
        metrics = {"tracked": n_tracked, "inliers": n_inl,
                   "alive": torch.sum(new_state.alive), "pose_ok": ok}
        return new_state, metrics

    return step


def make_step(cfg: StereoVoConfig, rectK, baseline: float):
    """The per-frame VO step: step(state, left, right) -> (state, metrics)
    on the rectified pair (tensors on the state's device)."""
    return _make_step_fn(cfg, rectK, baseline)


def make_sequence_runner(cfg: StereoVoConfig, rectK, baseline: float):
    """Whole-sequence VO: run(state, lefts [T,H,W], rights [T,H,W]) ->
    (state, ((Rs [T,3,3], ts [T,3]), metrics)) with per-frame world->camera
    poses and each metric stacked over frames."""
    step = _make_step_fn(cfg, rectK, baseline)

    def run(state: StereoVoState, lefts, rights):
        Rs, ts, ms = [], [], []
        for i in range(lefts.shape[0]):
            state, m = step(state, lefts[i], rights[i])
            Rs.append(state.R)
            ts.append(state.t)
            ms.append(m)
        metrics = {k: torch.stack([m[k] for m in ms]) for k in ms[0]}
        return state, ((torch.stack(Rs), torch.stack(ts)), metrics)

    return run


def make_bootstrap(cfg: StereoVoConfig, rectK, baseline: float):
    """First-frame initializer: boot(state, left, right) -> state."""
    pyr_cfg = PyramidConfig(scales=cfg.pyramid_scales)
    rect_k = _rect_k_on(rectK)

    def boot(state: StereoVoState, left, right):
        left = left.to(torch.float32)
        pyramid = pyramid_ops.pyramid_average(left, pyr_cfg)
        grads = pyramid_ops.gradient(pyramid)
        return _spawn(state, pyramid, grads, left, right.to(torch.float32),
                      rect_k(left.device), baseline, cfg)

    return boot


def bootstrap(state: StereoVoState, left, right, rectK, baseline,
              cfg: StereoVoConfig) -> StereoVoState:
    """Initialize the track pool from the first frame pair."""
    return make_bootstrap(cfg, rectK, baseline)(state, left, right)


class StereoVisualOdometry:
    """Host-facing front end (StereoVisualOdometry analog): owns the state on
    ``device``, exposes process(left, right) -> bool and the pose."""

    def __init__(self, cfg: StereoVoConfig, rectK, baseline: float,
                 height: int, width: int, seed: int = 0, device="cpu"):
        self.cfg = cfg
        self.device = torch.device(device)
        self.baseline = float(baseline)
        self._step = make_step(cfg, rectK, baseline)
        self._boot = make_bootstrap(cfg, rectK, baseline)
        self.state = init_state(cfg, height, width, seed, self.device)
        self._first = True
        self.metrics = {}

    def reset(self, seed: int = 0):
        self.state = init_state(self.cfg, 0, 0, seed, self.device)
        self._first = True

    def _tensor(self, image):
        return torch.as_tensor(image, dtype=torch.float32, device=self.device)

    def process(self, left, right) -> bool:
        if self._first:
            self.state = self._boot(self.state, self._tensor(left),
                                    self._tensor(right))
            self._first = False
            return True
        self.state, m = self._step(self.state, self._tensor(left),
                                   self._tensor(right))
        vals = torch.stack([v.to(torch.int64) for v in m.values()]).tolist()
        self.metrics = dict(zip(m.keys(), vals))     # one host sync
        return bool(self.metrics["pose_ok"])

    def camera_to_world(self):
        """Current camera->world SE3 as numpy (R, t)."""
        R, t = se3.invert(self.state.R, self.state.t)
        return R.cpu().numpy(), t.cpu().numpy()
