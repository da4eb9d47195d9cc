"""Sparse bundle adjustment on a BAL-convention problem (port of
``boofcv_tpu/examples/bundle_adjustment.py``).

Reference analog: examples/sfm/ExampleBundleAdjustment.java.  A BAL-format
file is synthesized (snavely camera: f, k1, k2), round-tripped through the
codec, then optimized with the LM-Schur solver.

    python -m boofcv_tpu_torch.examples.bundle_adjustment [--device cpu|cuda]
"""

from __future__ import annotations

import os
import tempfile

import numpy as np
import torch

from boofcv_tpu_torch._config import resolve_device
from boofcv_tpu_torch.examples import parse_device
from boofcv_tpu_torch.geo import ba, se3
from boofcv_tpu_torch.io import bal


def main(argv=None) -> int:
    dev = resolve_device(parse_device(argv))

    rng = np.random.default_rng(13)
    V, P = 8, 300
    pts = np.stack([rng.uniform(-2, 2, P), rng.uniform(-2, 2, P),
                    -rng.uniform(4, 8, P)], 1)   # snavely looks down -z
    Rs, ts = [], []
    for v in range(V):
        Rs.append(se3.exp_so3(torch.from_numpy(rng.normal(0, 0.02, 3)))
                  .numpy())
        ts.append(np.array([0.4 * v - 1.5, 0.04 * v, 0.02 * v]))
    Rs, ts = np.stack(Rs), np.stack(ts)
    intr = np.stack([np.full(V, 480.0), np.full(V, 0.0), np.full(V, 0.0)], 1)

    L = 4
    obs_xy = np.zeros((P, L, 2))
    obs_view = np.zeros((P, L), np.int32)
    obs_valid = np.zeros((P, L), bool)
    for p in range(P):
        for s, v in enumerate(sorted(rng.permutation(V)[:L])):
            Xc = Rs[v] @ pts[p] + ts[v]
            proj = ba._project("snavely", torch.from_numpy(Xc),
                               torch.from_numpy(intr[v])).numpy()
            obs_xy[p, s] = proj + rng.normal(0, 0.3, 2)
            obs_view[p, s] = v
            obs_valid[p, s] = True
    fixed = np.zeros(V, bool)
    fixed[:2] = True
    prob = ba.make_problem(Rs, ts, pts, obs_xy, obs_view, obs_valid,
                           intr=intr, model="snavely", fixed_views=fixed,
                           device=dev)

    # round-trip through the BAL codec (the reference example's input path)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "problem.txt")
        bal.write_bal(path, prob)
        prob = bal.to_problem(bal.read_bal(path), device=dev)
    prob = prob._replace(fixed_views=torch.from_numpy(fixed).to(dev))

    # perturb so BA has work to do
    prob = prob._replace(
        points=prob.points + torch.from_numpy(
            rng.normal(0, 0.05, (P, 3))).to(dev),
        t=prob.t + torch.from_numpy(rng.normal(0, 0.02, (V, 3))).to(dev))
    out, info = ba.optimize(prob, iterations=15)
    c0, c1 = float(info["initial_cost"]), float(info["final_cost"])
    n_obs = int(obs_valid.sum())
    rms = np.sqrt(2 * c1 / (2 * n_obs))
    print(f"device: {dev}")
    print(f"observations: {n_obs}, views {V}, points {P}")
    print(f"cost: {c0:.2f} -> {c1:.2f} (reproj RMS {rms:.3f} px, "
          f"noise 0.3 px)")
    ok = c1 < c0 * 0.05 and rms < 0.6
    print("OK" if ok else "FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
