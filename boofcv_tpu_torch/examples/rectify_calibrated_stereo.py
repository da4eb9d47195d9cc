"""Rectify a calibrated stereo pair (port of
``boofcv_tpu/examples/rectify_calibrated_stereo.py``).

Reference analog: examples/stereo/ExampleRectifyCalibratedStereo.java —
compute rectifying homographies from the calibrated rig, warp both images,
verify epipolar rows align.  Oracle: corresponding points land on the same
row after rectification, and dense BM on the rectified pair recovers the
scene depth. The JAX example's ``--tpu`` flag and ``setup_backend`` have no
counterpart: ``--device`` picks the device.

    python -m boofcv_tpu_torch.examples.rectify_calibrated_stereo [--device cpu|cuda]
"""

from __future__ import annotations

import numpy as np
import torch

from boofcv_tpu_torch._config import resolve_device
from boofcv_tpu_torch.examples import parse_device
from boofcv_tpu_torch.feature import disparity
from boofcv_tpu_torch.geo import rectify, se3
from boofcv_tpu_torch.io import simulate
from boofcv_tpu_torch.ip import distort

H, W = 160, 220
K = np.array([[170.0, 0, W / 2], [0, 170.0, H / 2], [0, 0, 1.0]])
T_REL = np.array([-0.3, 0.0, 0.0])


def _scene():
    """(R_rel, left, right) of a verged rig: the right camera rotated inward
    4 deg (rows misalign without rectification)."""
    rng = np.random.default_rng(1)
    tex = simulate.noise_texture(rng)
    R_rel = se3.exp_so3(torch.tensor([0.0, -0.07, 0.01],
                                     dtype=torch.float64)).numpy()
    kw = dict(plane_origin=(0.0, 0.0, 5.0), plane_y=(0.0, 1.0, -0.2),
              texture_scale=45.0)
    left = simulate.render_plane(tex, K, np.eye(3), np.zeros(3), H, W, **kw)
    right = simulate.render_plane(tex, K, R_rel, T_REL, H, W, **kw)
    return R_rel, left, right


def main(argv=None) -> int:
    dev = resolve_device(parse_device(argv))
    R_rel, left, right = _scene()
    rp = rectify.rectify_calibrated(K, K, R_rel, T_REL, device=dev)
    rl = distort.warp_homography(torch.as_tensor(left, device=dev),
                                 torch.linalg.inv(rp.rect1), (H, W))
    rr = distort.warp_homography(torch.as_tensor(right, device=dev),
                                 torch.linalg.inv(rp.rect2), (H, W))
    cfg = disparity.DisparityConfig(max_disparity=48, radius_x=3,
                                    radius_y=3, texture_threshold=0.0)
    d = disparity.block_match(rl, rr, cfg).cpu().numpy()
    print(f"device: {dev}")
    valid = d > 0.5
    # depth from disparity must be ~5 m at the plane centre
    Krect = rp.rectK.cpu().numpy()
    z = Krect[0, 0] * rp.baseline / np.maximum(d, 1e-6)
    center_sl = np.s_[H // 2 - 15:H // 2 + 15, W // 2 - 15:W // 2 + 15]
    z_med = np.median(z[center_sl][valid[center_sl]])
    print(f"rectified-pair valid disparity: {valid.mean():.0%}; center "
          f"depth {z_med:.2f} m (true ~5)")
    ok = valid.mean() > 0.5 and abs(z_med - 5.0) < 0.5
    print("OK" if ok else "FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
