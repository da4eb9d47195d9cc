"""Sliding-window bundle adjustment for visual odometry (port of
``boofcv_tpu/sfm/window_ba.py``).

The last W keyframes' poses and their shared tracks are jointly refined
with the LM-Schur solver.  A host-side ring buffer is keyed by the VO track
pool's stable uids; the BA problem is assembled on the host in the dense
[P, L<=W] layout and solved on the device.
"""

from __future__ import annotations

from collections import OrderedDict

import numpy as np
import torch

from boofcv_tpu_torch._config import resolve_device
from boofcv_tpu_torch.geo import ba


def _read_state(state):
    """The seven fields ``push`` needs, packed into one float64 vector on
    the state's device and brought to the host in one transfer (float32
    positions, int32 uids and the mask are exact in float64)."""
    n = state.xs.shape[0]
    buf = torch.cat([state.alive.to(torch.float64),
                     state.uid.to(torch.float64),
                     state.xs.to(torch.float64), state.ys.to(torch.float64),
                     state.world.reshape(-1), state.R.reshape(-1),
                     state.t]).cpu().numpy()
    alive, uid, xs, ys = buf[:4 * n].reshape(4, n)
    world, R, t = np.split(buf[4 * n:], [3 * n, 3 * n + 9])
    return (alive.astype(bool), uid.astype(np.int32), xs.astype(np.float32),
            ys.astype(np.float32), world.reshape(n, 3), R.reshape(3, 3), t)


class SlidingWindowBA:
    """``device`` is where the window is solved (None: the card; raises
    ``RuntimeError`` without one)."""

    def __init__(self, window: int = 8, min_track_len: int = 2,
                 iterations: int = 8, device=None):
        self.window = window
        self.min_track_len = min_track_len
        self.iterations = iterations
        self.device = resolve_device(device)
        self.frames: list = []      # dicts: R, t, uids, obs (normalized)
        self.world: OrderedDict = OrderedDict()  # uid -> xyz (latest)

    def push(self, state, fx: float, fy: float, cx: float, cy: float):
        """Record the current (single-stream) VO state as a keyframe: one
        device->host transfer."""
        alive, uid, xs, ys, world, R, t = _read_state(state)
        uids = uid[alive]
        xs = xs[alive]
        ys = ys[alive]
        obs = np.stack([(xs - cx) / fx, (ys - cy) / fy], 1)
        world = world[alive]
        for u, w in zip(uids, world):
            self.world[int(u)] = w
        self.frames.append({"R": R, "t": t, "uids": uids, "obs": obs})
        if len(self.frames) > self.window:
            self.frames.pop(0)

    def assemble(self):
        """The window as arrays for ``ba.make_problem``: (track_ids, Rs, ts,
        pts, obs_xy, obs_view, obs_valid, fixed), or None if
        underconstrained."""
        V = len(self.frames)
        if V < 3:
            return None
        # tracks seen in >= min_track_len frames of the window
        counts: dict = {}
        for f in self.frames:
            for u in f["uids"]:
                counts[int(u)] = counts.get(int(u), 0) + 1
        track_ids = [u for u, c in counts.items()
                     if c >= self.min_track_len and u in self.world]
        if len(track_ids) < 12:
            return None
        pid = {u: i for i, u in enumerate(track_ids)}
        P = len(track_ids)
        L = self.window
        obs_xy = np.zeros((P, L, 2))
        obs_view = np.zeros((P, L), np.int32)
        obs_valid = np.zeros((P, L), bool)
        slot = np.zeros(P, np.int32)
        for v, f in enumerate(self.frames):
            for u, o in zip(f["uids"], f["obs"]):
                i = pid.get(int(u))
                if i is None or slot[i] >= L:
                    continue
                obs_xy[i, slot[i]] = o
                obs_view[i, slot[i]] = v
                obs_valid[i, slot[i]] = True
                slot[i] += 1
        pts = np.stack([self.world[u] for u in track_ids])
        Rs = np.stack([f["R"] for f in self.frames])
        ts = np.stack([f["t"] for f in self.frames])
        fixed = np.zeros(V, bool)
        fixed[:2] = True    # pin gauge incl. scale on the two oldest
        return track_ids, Rs, ts, pts, obs_xy, obs_view, obs_valid, fixed

    def optimize(self):
        """Refine window poses + points.  Returns
        (refined [ (R, t) per frame ], info) or None if underconstrained.
        ``info`` is the solver's, plus ``tracks``, ``observations`` (kept
        after the trim) and ``keep`` [P, L]."""
        window = self.assemble()
        if window is None:
            return None
        track_ids, Rs, ts, pts, obs_xy, obs_view, obs_valid, fixed = window
        # float32: normalized-coordinate residuals at the 1e-4 level are
        # well inside its range and LM only needs descent-quality steps
        prob = ba.make_problem(Rs, ts, pts, obs_xy, obs_view, obs_valid,
                               fixed_views=fixed, dtype=torch.float32,
                               device=self.device)
        # trimmed least squares: the VO data contains KLT-drift outliers
        # and plain LM would absorb them into the poses — drop
        # observations whose initial residual is far beyond the median
        r0 = ba.residuals(prob).cpu().numpy()
        err = np.linalg.norm(r0, axis=-1)
        med = np.median(err[obs_valid]) + 1e-12
        keep = obs_valid & (err < 6.0 * med)
        # points need >= 2 surviving observations
        enough = keep.sum(axis=1) >= 2
        keep &= enough[:, None]
        prob = prob._replace(obs_valid=torch.from_numpy(keep).to(self.device))
        out, info = ba.optimize(prob, iterations=self.iterations)
        R_out = out.R.cpu().numpy()
        t_out = out.t.cpu().numpy()
        refined = [(R_out[v], t_out[v]) for v in range(len(self.frames))]
        # write refined points back
        new_pts = out.points.cpu().numpy()
        for i, u in enumerate(track_ids):
            self.world[u] = new_pts[i]
        for v, f in enumerate(self.frames):
            f["R"], f["t"] = refined[v]
        info = dict(info, tracks=len(track_ids),
                    observations=int(keep.sum()), keep=keep)
        return refined, info
