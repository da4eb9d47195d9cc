"""Dense disparity to a 3D point cloud (port of
``boofcv_tpu/examples/stereo_disparity_3d.py``).

Reference analog: examples/stereo/ExampleStereoDisparity3D.java — dense
block-matching disparity lifted to camera-frame 3D points (z = f*B/d, x =
(u-cx)z/f, y = (v-cy)z/f).  Oracle: the cloud from a rendered slanted plane
must fit a plane with small residual. The JAX example's ``--tpu`` flag and
``setup_backend`` have no counterpart: ``--device`` picks the device.

    python -m boofcv_tpu_torch.examples.stereo_disparity_3d [--device cpu|cuda]
"""

from __future__ import annotations

import numpy as np
import torch

from boofcv_tpu_torch._config import resolve_device
from boofcv_tpu_torch.examples import parse_device
from boofcv_tpu_torch.feature import disparity
from boofcv_tpu_torch.io import simulate

H, W = 160, 220
F, B = 170.0, 0.3
K = np.array([[F, 0, W / 2], [0, F, H / 2], [0, 0, 1.0]])


def _scene():
    """(left, right) of a tilted plane 5 m ahead."""
    rng = np.random.default_rng(0)
    return simulate.render_stereo_sequence(
        rng, K, B, [(np.eye(3), np.zeros(3))], H, W,
        plane_origin=(0.0, 0.0, 5.0), plane_y=(0.0, 1.0, -0.25),
        texture_scale=45.0)[0]


def main(argv=None) -> int:
    dev = resolve_device(parse_device(argv))
    left, right = _scene()
    cfg = disparity.DisparityConfig(max_disparity=32, radius_x=3,
                                    radius_y=3, texture_threshold=0.0)
    d = disparity.block_match(torch.as_tensor(left, device=dev),
                              torch.as_tensor(right, device=dev),
                              cfg).cpu().numpy()
    print(f"device: {dev}")
    valid = d > 1.0
    vs, us = np.nonzero(valid)
    z = F * B / d[valid]
    x = (us - W / 2) * z / F
    y = (vs - H / 2) * z / F
    cloud = np.stack([x, y, z], 1)
    # keep sane-range points and fit a plane
    keep = (z > 1.0) & (z < 20.0)
    cloud = cloud[keep]
    A = np.c_[cloud[:, :2], np.ones(len(cloud))]
    coef, *_ = np.linalg.lstsq(A, cloud[:, 2], rcond=None)
    resid = np.abs(A @ coef - cloud[:, 2])
    print(f"cloud points: {len(cloud)} ({valid.mean():.0%} valid), "
          f"plane fit z = {coef[0]:.3f}x + {coef[1]:.3f}y + {coef[2]:.2f}, "
          f"median residual {np.median(resid):.3f} m")
    ok = len(cloud) > 5000 and np.median(resid) < 0.08 \
        and abs(coef[2] - 5.0) < 0.5
    print("OK" if ok else "FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
