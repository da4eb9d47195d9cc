"""Stereo visual odometry: KLT tracking + sparse stereo depth + RANSAC P3P
(port of ``boofcv_tpu/sfm/stereo_vo.py``: the single-stream path and the
B-stream path).

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

B independent streams (a camera rig, a fleet replay, a dataset evaluation)
run as one step: a stacked state carries a leading stream axis on every
tensor and one generator per stream, and the same code runs one pass of
tensor ops over that axis, with one launch of each kernel and one host
sync, whatever B is.  Where the reference vmaps its step, every function
below the step takes the axis itself.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, NamedTuple, Tuple, Union

import numpy as np
import torch

from boofcv_tpu_torch._config import resolve_device
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
    """Fixed-capacity VO state on one device: of one stream, or stacked
    over B streams with a leading [B] on every tensor."""
    xs: torch.Tensor          # [N] f32 track x (rectified-left pixels)
    ys: torch.Tensor          # [N] f32
    world: torch.Tensor       # [N, 3] f64 points in the world frame
    alive: torch.Tensor       # [N] bool
    templates: klt.KltTemplates
    R: torch.Tensor           # [3, 3] f64 world->camera
    t: torch.Tensor           # [3] f64
    # RANSAC draws (forked by every step); stacked: one generator a stream
    rng: Union[torch.Generator, Tuple[torch.Generator, ...]]
    uid: torch.Tensor         # [N] int32 stable track id
    next_uid: torch.Tensor    # scalar int32


_TENSOR_FIELDS = ("xs", "ys", "world", "alive", "R", "t", "uid", "next_uid")


def _map_tensors(fn, *states: StereoVoState) -> StereoVoState:
    """``fn`` over the corresponding tensors of ``states`` (templates
    level by level); the first state's generators are kept."""
    tm = klt.KltTemplates(*(
        tuple(fn(*level) for level in zip(*(getattr(s.templates, k)
                                            for s in states)))
        for k in klt.KltTemplates._fields))
    return states[0]._replace(templates=tm, **{
        k: fn(*(getattr(s, k) for s in states)) for k in _TENSOR_FIELDS})


def stream_state(states: StereoVoState, b: int) -> StereoVoState:
    """Stream ``b`` of a stacked state, as a single-stream state."""
    return _map_tensors(lambda a: a[b], states)._replace(rng=states.rng[b])


def _generator(device, seed: int) -> torch.Generator:
    g = torch.Generator(device=torch.device(device))
    g.manual_seed(int(seed))
    return g


def _fork(g):
    """A copy of ``g`` (a generator, or a stacked state's tuple of them) at
    its current position (host-side state only)."""
    if not isinstance(g, torch.Generator):
        return tuple(_fork(x) for x in g)
    out = torch.Generator(device=g.device)
    out.set_state(g.get_state())
    return out


def init_state(cfg: StereoVoConfig, height: int, width: int, seed: int = 0,
               device=None) -> StereoVoState:
    """An empty track pool on ``device`` (None: the card; raises without
    one)."""
    n = cfg.num_tracks
    p = 2 * cfg.template_radius + 1
    dev = resolve_device(device)
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


def init_batched_state(cfg: StereoVoConfig, num_streams: int, height: int,
                       width: int, seed: int = 0,
                       device=None) -> StereoVoState:
    """Stacked state for ``num_streams`` independent VO streams on
    ``device`` (None: the card; raises without one): a leading stream axis
    on every tensor, and stream i's RANSAC generator seeded ``seed + i``,
    so it draws what a single-stream state with that seed draws."""
    dev = resolve_device(device)
    states = [init_state(cfg, height, width, seed + i, dev)
              for i in range(num_streams)]
    return _map_tensors(lambda *a: torch.stack(a), *states)._replace(
        rng=tuple(s.rng for s in states))


def _key_to_seed(key) -> int:
    """The reference's PRNGKey(seed) holds [seed >> 32, seed & 0xffffffff]."""
    k = np.asarray(key).astype(np.uint64).ravel()
    return int((int(k[0]) << 32) | int(k[1]))


def state_from_numpy(d: dict, device=None) -> StereoVoState:
    """Build the port's state from numpy arrays named like the reference's
    ``StereoVoState`` fields (``templates`` as a dict of per-level lists
    ``desc`` / ``grad_x`` / ``grad_y``).  The reference's ``key`` maps to a
    seed and the generator is rebuilt from it; an ``rng_state`` entry
    (written by :func:`state_to_numpy`) restores the generator exactly.
    A stacked state (every array with a leading [B], ``key`` [B, 2]) gives
    a stacked state with one generator per stream.
    ``device`` None means the card, and raises without one."""
    dev = resolve_device(device)

    def f(a, dtype):
        return torch.as_tensor(np.array(a), dtype=dtype, device=dev)

    def generator(key, rng_state):
        if rng_state is None:
            return _generator(dev, _key_to_seed(key))
        g = torch.Generator(device=dev)
        g.set_state(torch.as_tensor(np.array(rng_state), dtype=torch.uint8))
        return g

    tm = d["templates"]
    tl = lambda k: tuple(f(a, torch.float32) for a in tm[k])
    keys = np.asarray(d["key"])
    saved = d.get("rng_state")
    if keys.ndim == 1:
        rng = generator(keys, saved)
    else:
        rng = tuple(generator(k, None if saved is None else saved[i])
                    for i, k in enumerate(keys))
    return StereoVoState(
        xs=f(d["xs"], torch.float32), ys=f(d["ys"], torch.float32),
        world=f(d["world"], torch.float64), alive=f(d["alive"], torch.bool),
        templates=klt.KltTemplates(tl("desc"), tl("grad_x"), tl("grad_y")),
        R=f(d["R"], torch.float64), t=f(d["t"], torch.float64), rng=rng,
        uid=f(d["uid"], torch.int32), next_uid=f(d["next_uid"], torch.int32))


def state_to_numpy(state: StereoVoState) -> dict:
    """The inverse of :func:`state_from_numpy` (``key`` from the
    generator's seed, ``rng_state`` for its exact position; [B, 2] and
    [B, bytes] for a stacked state)."""
    a = lambda x: x.detach().cpu().numpy()

    def key(g):
        seed = g.initial_seed()
        return np.array([(seed >> 32) & 0xffffffff, seed & 0xffffffff],
                        np.uint32)

    rng = lambda fn: (fn(state.rng) if isinstance(state.rng, torch.Generator)
                      else np.stack([fn(g) for g in state.rng]))
    return {
        "xs": a(state.xs), "ys": a(state.ys), "world": a(state.world),
        "alive": a(state.alive),
        "templates": {k: [a(x) for x in getattr(state.templates, k)]
                      for k in ("desc", "grad_x", "grad_y")},
        "R": a(state.R), "t": a(state.t),
        "key": rng(key),
        "rng_state": rng(lambda g: g.get_state().numpy()),
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

    d2 = ((cand_x[..., :, None] - state.xs[..., None, :]) ** 2
          + (cand_y[..., :, None] - state.ys[..., None, :]) ** 2)
    d2 = torch.where(state.alive[..., None, :], d2, float("inf"))
    cand_ok = cand_ok & (torch.amin(d2, dim=-1) > (2 * cfg.detect_radius) ** 2)

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
    Xw = Xc @ Rinv.transpose(-1, -2) + tinv[..., None, :]

    # compact candidates into dead slots by rank, stream by stream;
    # duplicate writes land only on rank 0, which is never read, so write
    # order does not matter
    dead = ~state.alive
    slot_rank = torch.cumsum(dead.to(torch.int64), -1) * dead
    cand_rank = torch.cumsum(cand_ok.to(torch.int64), -1) * cand_ok
    by_rank = torch.zeros(cand_rank.shape[:-1] + (n + 1,), dtype=torch.int64,
                          device=dev)
    by_rank.scatter_(-1, cand_rank,
                     torch.arange(n, device=dev).expand(cand_rank.shape))
    n_cand = torch.amax(cand_rank, dim=-1, keepdim=True)
    take = dead & (slot_rank <= n_cand) & (slot_rank > 0)
    src = by_rank.gather(-1, torch.clamp(slot_rank, 0, n))

    new_xs = torch.where(take, cand_x.gather(-1, src), state.xs)
    new_ys = torch.where(take, cand_y.gather(-1, src), state.ys)
    new_world = torch.where(
        take[..., None], Xw.gather(-2, src[..., None].expand(Xw.shape)),
        state.world)
    new_alive = state.alive | take
    new_uid = torch.where(
        take, state.next_uid[..., None] + slot_rank.to(torch.int32) - 1,
        state.uid)
    next_uid = state.next_uid + torch.amax(slot_rank * take,
                                           dim=-1).to(torch.int32)

    # templates at the new positions; existing tracks keep their
    # spawn-time templates (the reference's KLT never re-describes a track)
    tmpl_new = klt.sample_templates(pyramid, grads, new_ys, new_xs,
                                    cfg.pyramid_scales, cfg.template_radius)
    mix = lambda new, old: tuple(torch.where(take[..., None, None], a, b)
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
    """(track_estimate, spawn_fn): the two halves of the per-frame step, of
    one stream or of a stacked state and [B, H, W] frames."""
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
        Rn = torch.where(ok[..., None, None], Rn, state.R)
        tn = torch.where(ok[..., None], tn, state.t)
        alive = tracked & (res.inliers | ~ok[..., None])

        new_state = state._replace(xs=xs, ys=ys, alive=alive, R=Rn, t=tn,
                                   rng=rng)
        frac = torch.mean(alive.to(torch.float32), dim=-1)
        return (new_state, pyramid, left, right.to(torch.float32), frac,
                (torch.sum(tracked, dim=-1), res.num_inliers, ok))

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
        # device->host sync.  As in the reference's batched step the spawn
        # runs for every stream when any stream needs it, and each stream
        # that does not keeps its state as it was.
        need = frac < cfg.respawn_below
        if bool(torch.any(need)):
            spawned = spawn_fn(new_state, pyramid, l32, r32)
            new_state = _map_tensors(
                lambda a, b: torch.where(
                    need.reshape(need.shape + (1,) * (a.dim() - need.dim())),
                    a, b), spawned, new_state)
        metrics = {"tracked": n_tracked, "inliers": n_inl,
                   "alive": torch.sum(new_state.alive, dim=-1),
                   "pose_ok": ok}
        return new_state, metrics

    return step


def make_step(cfg: StereoVoConfig, rectK, baseline: float):
    """The per-frame VO step: step(state, left, right) -> (state, metrics)
    on the rectified pair (tensors on the state's device)."""
    return _make_step_fn(cfg, rectK, baseline)


def _make_runner(cfg: StereoVoConfig, rectK, baseline: float,
                 shared_frames: bool):
    step = _make_step_fn(cfg, rectK, baseline)

    def run(state: StereoVoState, lefts, rights):
        streams = state.xs.shape[:-1]
        Rs, ts, ms = [], [], []
        for left, right in zip(lefts, rights):
            if shared_frames:
                # converted first: one float32 frame, viewed by every stream
                left = left.to(torch.float32).expand(streams + left.shape)
                right = right.to(torch.float32).expand(streams + right.shape)
            state, m = step(state, left, right)
            Rs.append(state.R)
            ts.append(state.t)
            ms.append(m)
        metrics = {k: torch.stack([m[k] for m in ms]) for k in ms[0]}
        return state, ((torch.stack(Rs), torch.stack(ts)), metrics)

    return run


def make_sequence_runner(cfg: StereoVoConfig, rectK, baseline: float):
    """Whole-sequence VO: run(state, lefts [T,H,W], rights [T,H,W]) ->
    (state, ((Rs [T,3,3], ts [T,3]), metrics)) with per-frame world->camera
    poses and each metric stacked over frames."""
    return _make_runner(cfg, rectK, baseline, shared_frames=False)


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


def _for_device(fn, device):
    """``fn(states, ...)`` bound to ``device`` (None: the card; raises
    ``RuntimeError`` without one): a state that lies elsewhere is refused,
    so a batched entry point built for the card never runs on the CPU
    because it was handed CPU tensors."""
    dev = resolve_device(device)

    def on_device(states: StereoVoState, *frames):
        at = states.xs.device
        if at.type != dev.type or (dev.index is not None
                                   and at.index != dev.index):
            raise ValueError(f"state on {at}, built for {dev}")
        if states.xs.dim() != 2:
            raise ValueError(f"a stacked state has xs [B, N], got "
                             f"{tuple(states.xs.shape)}")
        return fn(states, *frames)

    return on_device


def make_batched_step(cfg: StereoVoConfig, rectK, baseline: float,
                      device=None):
    """B independent VO streams in one step on ``device``:
    step(states, lefts [B,H,W], rights [B,H,W]) -> (states, metrics), each
    metric [B].  One pass of tensor ops over the stream axis, one launch of
    each kernel, one host sync (any stream low on tracks spawns all, and
    each stream picks its own result)."""
    return _for_device(_make_step_fn(cfg, rectK, baseline), device)


def make_batched_bootstrap(cfg: StereoVoConfig, rectK, baseline: float,
                           device=None):
    """First-frame initializer of a stacked state on ``device``:
    boot(states, lefts [B,H,W], rights [B,H,W]) -> states."""
    return _for_device(make_bootstrap(cfg, rectK, baseline), device)


def make_batched_sequence_runner(cfg: StereoVoConfig, rectK, baseline: float,
                                 shared_frames: bool = False, device=None):
    """T frames of B streams on ``device``:
    run(states, lefts [T,B,H,W], rights [T,B,H,W]) ->
    (states, ((Rs [T,B,3,3], ts [T,B,3]), metrics)), each metric [T, B].

    ``shared_frames=True`` takes lefts / rights as [T, H, W] and gives every
    stream a view of each frame (benchmark / dataset-replay mode: one copy
    of the sequence on the device, its pyramid built once per frame, B-fold
    tracking and pose work)."""
    return _for_device(_make_runner(cfg, rectK, baseline, shared_frames),
                       device)


def bootstrap(state: StereoVoState, left, right, rectK, baseline,
              cfg: StereoVoConfig) -> StereoVoState:
    """Initialize the track pool from the first frame pair."""
    return make_bootstrap(cfg, rectK, baseline)(state, left, right)


class StereoVisualOdometry:
    """Host-facing front end (StereoVisualOdometry analog): owns the state on
    ``device`` (None: the card; raises without one), exposes
    process(left, right) -> bool and the pose."""

    def __init__(self, cfg: StereoVoConfig, rectK, baseline: float,
                 height: int, width: int, seed: int = 0, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
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
