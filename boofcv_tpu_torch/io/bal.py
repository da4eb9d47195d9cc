"""Bundle-Adjustment-in-the-Large (BAL) dataset codec (port of
``boofcv_tpu/io/bal.py``).

Reference analog: boofcv-io io/geo/CodecBundleAdjustmentInTheLarge.java —
the BAL text format (http://grail.cs.washington.edu/projects/bal/):

    num_cameras num_points num_observations
    <obs>: camera_idx point_idx x y          (num_observations lines)
    <cameras>: 9 values each — rodrigues(3), t(3), f, k1, k2
    <points>: 3 values each

converted to and from the dense [P, L] BAProblem layout.  Host code: the
rotation conversions run through the port's ``se3`` on CPU tensors.
"""

from __future__ import annotations

import gzip
import sys

import numpy as np
import torch

from boofcv_tpu_torch.geo import ba, se3


def read_bal(path: str):
    """Parse a BAL file (optionally .gz).  Returns dict of raw arrays."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        tokens = f.read().split()
    n_cam, n_pts, n_obs = (int(tok) for tok in tokens[:3])
    end_obs = 3 + 4 * n_obs
    end_cams = end_obs + 9 * n_cam
    end_pts = end_cams + 3 * n_pts
    if len(tokens) < end_pts:
        raise ValueError(f"{path}: {len(tokens)} tokens, the header asks "
                         f"for {end_pts}")
    obs = np.array(tokens[3:end_obs], dtype=object).reshape(n_obs, 4)
    return {"camera_index": obs[:, 0].astype(np.int32),
            "point_index": obs[:, 1].astype(np.int32),
            "obs": obs[:, 2:].astype(np.float64),
            "cameras": np.array(tokens[end_obs:end_cams],
                                np.float64).reshape(n_cam, 9),
            "points": np.array(tokens[end_cams:end_pts],
                               np.float64).reshape(n_pts, 3)}


def to_problem(data, max_obs_per_point: int | None = None,
               device=None) -> ba.BAProblem:
    """BAL arrays -> BAProblem ('snavely' camera model, [P, L] layout) on
    ``device`` (None: the card; raises ``RuntimeError`` without one).

    Observations beyond max_obs_per_point (default: the true max) are
    dropped with a stderr warning reporting the count.
    """
    cams = data["cameras"]
    n_cam = cams.shape[0]
    pts = data["points"]
    n_pts = pts.shape[0]
    counts = np.bincount(data["point_index"], minlength=n_pts)
    L = int(counts.max()) if max_obs_per_point is None else max_obs_per_point

    obs_xy = np.zeros((n_pts, L, 2))
    obs_view = np.zeros((n_pts, L), np.int32)
    obs_valid = np.zeros((n_pts, L), bool)
    slot = np.zeros(n_pts, np.int32)
    dropped = 0
    for ci, pi, xy in zip(data["camera_index"], data["point_index"],
                          data["obs"]):
        s = slot[pi]
        if s >= L:
            dropped += 1
            continue
        obs_xy[pi, s] = xy
        obs_view[pi, s] = ci
        obs_valid[pi, s] = True
        slot[pi] = s + 1

    R = se3.exp_so3(torch.from_numpy(np.ascontiguousarray(cams[:, :3])))
    t = cams[:, 3:6]
    intr = cams[:, 6:9]
    fixed = np.zeros(n_cam, bool)
    fixed[0] = True
    if dropped:
        print(f"# bal.to_problem: dropped {dropped} observations beyond "
              f"max_obs_per_point={L}", file=sys.stderr)
    return ba.make_problem(R, t, pts, obs_xy, obs_view, obs_valid,
                           intr=intr, model="snavely", fixed_views=fixed,
                           device=device)


def write_bal(path: str, prob: ba.BAProblem) -> None:
    """BAProblem ('snavely') -> BAL text file."""
    d = ba.problem_to_numpy(prob)
    R, t, intr, pts = d["R"], d["t"], d["intr"], d["points"]
    ov, oval, oxy = d["obs_view"], d["obs_valid"], d["obs_xy"]
    n_obs = int(oval.sum())
    w = se3.log_so3(torch.from_numpy(R)).numpy()
    with open(path, "w") as f:
        f.write(f"{R.shape[0]} {pts.shape[0]} {n_obs}\n")
        for p in range(pts.shape[0]):
            for s in range(ov.shape[1]):
                if oval[p, s]:
                    f.write(f"{ov[p, s]} {p} {oxy[p, s, 0]:.16e} "
                            f"{oxy[p, s, 1]:.16e}\n")
        for v in range(R.shape[0]):
            for val in (*w[v], *t[v], *intr[v]):
                f.write(f"{val:.16e}\n")
        for p in range(pts.shape[0]):
            for val in pts[p]:
                f.write(f"{val:.16e}\n")
