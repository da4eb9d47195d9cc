"""Quad-matching stereo visual odometry (port of
``boofcv_tpu/sfm/quad_vo.py``).

Reference analog: boofcv-sfm alg/sfm/d3/VisOdomQuadPnP.java:62,173 —
features detected and described in all four images of two consecutive
stereo pairs (L0, R0 previous; L1, R1 current), associated left-right
under the epipolar constraint and previous-current per camera; features
matched consistently around the quad are triangulated in the previous
frame, and RANSAC-PnP gives the motion of the left camera.

No tracker and no hand kernel: SURF on both images every frame
(``ip/integral``, ``feature/fasthessian``, ``feature/describe``), three
mutual-nearest-neighbour matches over score matrices, index chaining around
the quad, then ``geo/robust.ransac_pnp``.  A rectified pair is assumed, so
the left-right gate is a row check and the lift is disparity-based.  The
step makes no host sync; RANSAC draws from a ``torch.Generator`` in the
state, forked every step.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from boofcv_tpu_torch._config import resolve_device
from boofcv_tpu_torch.feature import associate, describe, fasthessian
from boofcv_tpu_torch.geo import robust, se3
from boofcv_tpu_torch.geo.rectify import pixel_to_3d_rectified
from boofcv_tpu_torch.ip import integral
from boofcv_tpu_torch.sfm import stereo_vo as svo


@dataclass(frozen=True)
class QuadVoConfig:
    num_features: int = 256
    max_disparity: float = 96.0
    epipolar_tol_px: float = 2.0        # |yL - yR| gate (rectified rows)
    max_match_error: float = 0.35       # SURF descriptor distance gate
    # (compared as squared euclidean internally)
    ransac_hypotheses: int = 256
    inlier_threshold_px: float = 1.5
    refine_iterations: int = 10


class FrameFeatures(NamedTuple):
    """One image's fixed-capacity detection set."""
    ys: torch.Tensor      # [N] f32
    xs: torch.Tensor      # [N] f32
    desc: torch.Tensor    # [N, 64] f32 SURF
    valid: torch.Tensor   # [N] bool


class QuadVoState(NamedTuple):
    left: FrameFeatures
    right: FrameFeatures
    lr_dst: torch.Tensor    # [N] int32: left i -> right index (previous pair)
    lr_ok: torch.Tensor     # [N] bool stereo match validity
    R: torch.Tensor         # [3, 3] f64 world->left camera
    t: torch.Tensor         # [3] f64
    rng: torch.Generator    # RANSAC draws, forked by every step


_FEATURE_DTYPES = (torch.float32, torch.float32, torch.float32, torch.bool)


def detect_describe(image, n: int) -> FrameFeatures:
    """SURF detect + describe (upright) on one image (DetectDescribeMulti
    analog)."""
    ii = integral.transform(image.to(torch.float32))
    det = fasthessian.detect(ii, max_features=n)
    desc = describe.surf(ii, det.ys, det.xs, det.scales)
    return FrameFeatures(det.ys.to(torch.float32), det.xs.to(torch.float32),
                         desc.to(torch.float32), det.valid)


def _stereo_match(l: FrameFeatures, r: FrameFeatures, cfg: QuadVoConfig):
    """Left->right epipolar-gated mutual NN (assocL2R).  Gated-out pairs
    score float32's largest value: a row of them is a tie, which ``argmin``
    resolves to the first index on either device, as ``jnp.argmin`` does."""
    s = associate.score_euclidean_sq(l.desc, r.desc)
    disp = l.xs[:, None] - r.xs[None, :]
    gate = ((torch.abs(l.ys[:, None] - r.ys[None, :]) <= cfg.epipolar_tol_px)
            & (disp > 0.1) & (disp < cfg.max_disparity))
    s = torch.where(gate, s, torch.finfo(torch.float32).max)
    return associate.associate_mutual(s, l.valid, r.valid,
                                      max_error=cfg.max_match_error ** 2)


def _frame_match(a: FrameFeatures, b: FrameFeatures, cfg: QuadVoConfig):
    """Previous->current mutual NN in one camera (assocSame)."""
    s = associate.score_euclidean_sq(a.desc, b.desc)
    return associate.associate_mutual(s, a.valid, b.valid,
                                      max_error=cfg.max_match_error ** 2)


def init_state(cfg: QuadVoConfig, seed: int = 0, device=None) -> QuadVoState:
    """An empty state on ``device`` (None: the card; raises without one)."""
    n = cfg.num_features
    dev = resolve_device(device)
    empty = FrameFeatures(torch.zeros((n,), dtype=torch.float32, device=dev),
                          torch.zeros((n,), dtype=torch.float32, device=dev),
                          torch.zeros((n, 64), dtype=torch.float32,
                                      device=dev),
                          torch.zeros((n,), dtype=torch.bool, device=dev))
    return QuadVoState(empty, empty,
                       torch.zeros((n,), dtype=torch.int32, device=dev),
                       torch.zeros((n,), dtype=torch.bool, device=dev),
                       torch.eye(3, dtype=torch.float64, device=dev),
                       torch.zeros((3,), dtype=torch.float64, device=dev),
                       svo._generator(dev, seed))


def state_from_numpy(d: dict, device=None) -> QuadVoState:
    """The port's state from numpy arrays named like the reference's
    ``QuadVoState`` fields (``left`` / ``right`` as dicts of ``ys``, ``xs``,
    ``desc``, ``valid``).  ``key`` maps to a seed; ``rng_state`` (from
    :func:`state_to_numpy`) restores the generator exactly.  ``device``
    None means the card."""
    dev = resolve_device(device)
    f = lambda a, dtype: torch.as_tensor(np.array(a), dtype=dtype, device=dev)
    feats = lambda x: FrameFeatures(*(f(x[k], dt) for k, dt in zip(
        FrameFeatures._fields, _FEATURE_DTYPES)))
    rng = svo._generator_from_numpy(d["key"], d.get("rng_state"), dev)
    return QuadVoState(feats(d["left"]), feats(d["right"]),
                       f(d["lr_dst"], torch.int32), f(d["lr_ok"], torch.bool),
                       f(d["R"], torch.float64), f(d["t"], torch.float64),
                       rng)


def state_to_numpy(state: QuadVoState) -> dict:
    """The inverse of :func:`state_from_numpy`."""
    a = lambda x: x.detach().cpu().numpy()
    feats = lambda ff: {k: a(v) for k, v in ff._asdict().items()}
    return {"left": feats(state.left), "right": feats(state.right),
            "lr_dst": a(state.lr_dst), "lr_ok": a(state.lr_ok),
            "R": a(state.R), "t": a(state.t),
            "key": svo._seed_key(state.rng),
            "rng_state": state.rng.get_state().numpy()}


def make_step(cfg: QuadVoConfig, rectK, baseline: float):
    """step(state, left, right) -> (state, metrics) on the rectified pair
    (tensors on the state's device)."""
    rectK = np.asarray(rectK, np.float64)
    fx = float(rectK[0, 0])
    fy = float(rectK[1, 1])
    cx = float(rectK[0, 2])
    cy = float(rectK[1, 2])
    norm_thresh = (cfg.inlier_threshold_px / fx) ** 2
    rect_k = svo._rect_k_on(rectK)

    def step(state: QuadVoState, left, right):
        n = cfg.num_features
        l1 = detect_describe(left, n)
        r1 = detect_describe(right, n)
        m_lr1 = _stereo_match(l1, r1, cfg)          # current stereo pair
        m_l01 = _frame_match(state.left, l1, cfg)   # left previous->current
        m_r01 = _frame_match(state.right, r1, cfg)  # right previous->current

        # the quad per previous-left feature i (0=L0 1=R0 2=L1 3=R1):
        # i --lr0--> j0 (R0), i --l01--> i1 (L1), i1 --lr1--> j1 (R1);
        # consistent iff R0's previous->current match lands on j1
        i1 = m_l01.dst.long()
        j0 = state.lr_dst.long()
        j1 = m_lr1.dst[i1]
        quad_ok = (state.lr_ok & m_l01.valid & m_lr1.valid[i1]
                   & m_r01.valid[j0] & (m_r01.dst[j0] == j1))

        # triangulate in the previous left camera frame (rectified stereo)
        disp = state.left.xs - state.right.xs[j0]
        Xp = pixel_to_3d_rectified(state.left.xs.to(torch.float64),
                                   state.left.ys.to(torch.float64),
                                   disp.to(torch.float64),
                                   rect_k(left.device), baseline)
        quad_ok = quad_ok & (disp > 0.1)

        # motion: world = previous left camera, observed in the current one
        obs = torch.stack([(l1.xs[i1] - cx) / fx, (l1.ys[i1] - cy) / fy],
                          dim=-1).to(torch.float64)
        rng = svo._fork(state.rng)
        res, (Rd, td) = robust.ransac_pnp(
            rng, Xp, obs, num_hypotheses=cfg.ransac_hypotheses,
            inlier_threshold=norm_thresh, valid_mask=quad_ok,
            refine_iterations=cfg.refine_iterations)
        ok = res.num_inliers >= 6
        # (Rd, td): previous left -> current left, so
        # world->current = delta o world->previous
        Rn, tn = se3.compose(Rd, td, state.R, state.t)
        Rn = torch.where(ok, Rn, state.R)
        tn = torch.where(ok, tn, state.t)
        new_state = QuadVoState(l1, r1, m_lr1.dst, m_lr1.valid, Rn, tn, rng)
        return new_state, {"quads": torch.sum(quad_ok),
                           "inliers": res.num_inliers, "pose_ok": ok}

    return step


def make_bootstrap(cfg: QuadVoConfig):
    """boot(state, left, right) -> state: the first pair's features and
    stereo matches."""
    def boot(state: QuadVoState, left, right):
        l0 = detect_describe(left, cfg.num_features)
        r0 = detect_describe(right, cfg.num_features)
        m = _stereo_match(l0, r0, cfg)
        return state._replace(left=l0, right=r0, lr_dst=m.dst, lr_ok=m.valid)
    return boot


class QuadVisualOdometry:
    """Host front end (abst StereoVisualOdometry analog, quad method): owns the
    state on ``device`` (None: the card; raises without one)."""

    def __init__(self, cfg: QuadVoConfig, rectK, baseline: float,
                 seed: int = 0, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self._step = make_step(cfg, rectK, float(baseline))
        self._boot = make_bootstrap(cfg)
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
