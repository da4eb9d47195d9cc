"""Dense stereo disparity: block matching and semi-global matching (port of
``boofcv_tpu/examples/stereo_disparity.py``).

Reference analog: examples/stereo/ExampleStereoDisparity.java (BM +
ConfigDisparityBMBest5) and the SGM variants.  A rectified stereo pair is
rendered from a textured slanted plane with known depth, so the disparity
maps are checked against the analytic ground truth. The JAX example's
``--tpu`` flag and ``setup_backend`` have no counterpart: ``--device`` picks
the device.

    python -m boofcv_tpu_torch.examples.stereo_disparity [--device cpu|cuda]
"""

from __future__ import annotations

import numpy as np
import torch

from boofcv_tpu_torch._config import resolve_device
from boofcv_tpu_torch.examples import parse_device
from boofcv_tpu_torch.feature import disparity
from boofcv_tpu_torch.io import simulate

H, W = 120, 160
F, B = 150.0, 0.3
K = np.array([[F, 0, W / 2], [0, F, H / 2], [0, 0, 1.0]])


def _scene():
    """(left, right) of a frontal plane 4 m ahead."""
    rng = np.random.default_rng(5)
    return simulate.render_stereo_sequence(
        rng, K, B, [(np.eye(3), np.zeros(3))], H, W,
        plane_origin=(0.0, 0.0, 4.0))[0]


def main(argv=None) -> int:
    dev = resolve_device(parse_device(argv))
    left, right = _scene()
    d_gt = F * B / 4.0   # frontal plane: constant disparity
    print(f"device: {dev}")
    results = {}
    cfg = disparity.DisparityConfig(min_disparity=0, max_disparity=24,
                                    radius_x=3, radius_y=3)
    for name, fn in [
        ("block_match", lambda l, r: disparity.block_match(l, r, cfg)),
        ("best5", lambda l, r: disparity.block_match_best5(l, r, cfg)),
        ("sgm", lambda l, r: disparity.sgm(
            l, r, disparity.SgmConfig(min_disparity=0, max_disparity=24))),
    ]:
        d = fn(torch.as_tensor(left, device=dev),
               torch.as_tensor(right, device=dev)).cpu().numpy()
        valid = d >= 0
        err = np.abs(d[valid] - d_gt)
        results[name] = (float(valid.mean()), float(np.median(err)))
        print(f"{name:12s}: valid {valid.mean()*100:5.1f}%  "
              f"median |d - d_gt| = {np.median(err):.2f} px "
              f"(d_gt = {d_gt:.2f})")
    ok = all(v > 0.5 and e < 1.0 for v, e in results.values())
    print("OK" if ok else "FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
