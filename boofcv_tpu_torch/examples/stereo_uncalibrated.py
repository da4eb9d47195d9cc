"""Dense disparity from two UNCALIBRATED images (port of
``boofcv_tpu/examples/stereo_uncalibrated.py``).

Reference analog: examples/stereo/ExampleStereoUncalibrated.java — match
features between two views of unknown cameras, estimate F robustly,
projectively rectify (Hartley), then run dense block-matching disparity on
the rectified pair. RANSAC draws its samples from a seeded
``torch.Generator`` where the JAX example uses ``jax.random.PRNGKey(0)``, so
the rectification is held to the truth (row alignment, dense disparity), not
to the JAX run's numbers. The JAX example's ``--tpu`` flag and
``setup_backend`` have no counterpart: ``--device`` picks the device.

    python -m boofcv_tpu_torch.examples.stereo_uncalibrated [--device cpu|cuda]
"""

from __future__ import annotations

import numpy as np
import torch

from boofcv_tpu_torch._config import resolve_device
from boofcv_tpu_torch.examples import parse_device
from boofcv_tpu_torch.feature import (associate, describe, disparity,
                                      fasthessian)
from boofcv_tpu_torch.geo import rectify, robust, se3
from boofcv_tpu_torch.io import simulate
from boofcv_tpu_torch.ip import distort, integral

H, W = 180, 240
K = np.array([[210.0, 0, W / 2], [0, 210.0, H / 2], [0, 0, 1.0]])


def _scene():
    """(img1, img2): a near patch over a far plane from two views.  F
    estimation needs non-coplanar structure (a single plane leaves F
    undetermined up to the plane homography)."""
    rng = np.random.default_rng(14)
    tex = simulate.noise_texture(rng, size=512, octaves=5) * 255
    tex_near = simulate.noise_texture(rng, size=160, octaves=4) * 255
    R2 = se3.exp_so3(torch.tensor([0.0, -0.05, 0.0],
                                  dtype=torch.float64)).numpy()
    t2 = np.array([0.45, 0.0, 0.02])

    def render(R, t):
        far = simulate.render_plane(tex, K, R, t, H, W,
                                    plane_origin=(0, 0, 6.0))
        near = simulate.render_plane(tex_near, K, R, t, H, W,
                                     plane_origin=(0.5, 0.2, 4.0))
        return np.where(near > 0, near, far).astype(np.float32)
    return render(np.eye(3), np.zeros(3)), render(R2, t2)


def _apply(Hm, p):
    q = np.concatenate([p, np.ones((len(p), 1))], 1) @ Hm.T
    return q[:, :2] / q[:, 2:]


def main(argv=None) -> int:
    dev = resolve_device(parse_device(argv))
    img1, img2 = _scene()
    print(f"device: {dev}")

    # SURF detect/describe + mutual association
    def dd(img):
        ii = integral.transform(torch.as_tensor(img, device=dev))
        det = fasthessian.detect(ii, max_features=200, threshold=1e3)
        ang = describe.orientation_average_haar(ii, det.ys, det.xs,
                                                det.scales)
        return det, describe.surf(ii, det.ys, det.xs, det.scales, ang)
    d1, f1 = dd(img1)
    d2, f2 = dd(img2)
    m = associate.associate_mutual(associate.score_euclidean_sq(f1, f2),
                                   max_error=0.3)
    h = lambda x: x.cpu().numpy()
    src, dst = h(m.src), h(m.dst)
    v = h(m.valid) & h(d1.valid)[src] & h(d2.valid)[dst]
    p1 = np.stack([h(d1.xs)[src][v], h(d1.ys)[src][v]], 1)
    p2 = np.stack([h(d2.xs)[dst][v], h(d2.ys)[dst][v]], 1)
    print(f"matched {len(p1)} SURF features")
    gen = torch.Generator(device=dev).manual_seed(0)
    res = robust.ransac_fundamental(
        gen, torch.as_tensor(p1, device=dev), torch.as_tensor(p2, device=dev),
        num_hypotheses=256, inlier_threshold_px=1.0)
    F = h(res.model[0])
    inl = h(res.inliers)
    print(f"F inliers: {int(inl.sum())}/{len(p1)}")
    r1, r2 = rectify.rectify_uncalibrated(F, p1[inl], p2[inl], W, H)
    r1, r2 = rectify.adjust_rectification(r1, r2, W, H)
    # projective rectification leaves an arbitrary x-offset between the
    # two images; shift image 2 so the observed disparities start at ~2px
    # (the reference example picks min/max disparity the same way)
    d_obs = _apply(r1, p1[inl])[:, 0] - _apply(r2, p2[inl])[:, 0]
    shift = np.floor(np.percentile(d_obs, 2)) - 2.0
    Tx = np.eye(3)
    Tx[0, 2] = shift
    r2 = Tx @ r2
    d_range = int(np.ceil(np.percentile(d_obs, 98) - shift)) + 4
    my1, mx1 = rectify.rectify_maps(r1, H, W, device=dev)
    my2, mx2 = rectify.rectify_maps(r2, H, W, device=dev)
    w1 = distort.warp(torch.as_tensor(img1, device=dev), my1, mx1)
    w2 = distort.warp(torch.as_tensor(img2, device=dev), my2, mx2)
    # row alignment check on the inlier correspondences
    dy = np.abs(_apply(r1, p1[inl])[:, 1] - _apply(r2, p2[inl])[:, 1])
    print(f"rectified row misalignment: median {np.median(dy):.2f} px")
    cfg = disparity.DisparityConfig(min_disparity=0,
                                    max_disparity=max(d_range, 8),
                                    radius_x=3, radius_y=3)
    d = h(disparity.block_match(w1, w2, cfg))
    valid = d >= 0
    print(f"dense disparity valid: {valid.mean()*100:.0f}% "
          f"(median {np.median(d[valid]):.1f} px)")
    ok = np.median(dy) < 1.0 and valid.mean() > 0.3
    print("OK" if ok else "FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
