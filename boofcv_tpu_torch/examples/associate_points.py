"""Detect SURF features in two views and associate them (port of
``boofcv_tpu/examples/associate_points.py``).

Reference analog: examples/features/ExampleAssociatePoints.java (SURF
detect/describe both images -> greedy association) +
ExampleFeatureSurf.java.  The second view is the first shifted by a known
offset, so every surviving match can be checked against ground truth. The
JAX example's ``--tpu`` flag and ``setup_backend`` have no counterpart:
``--device`` picks the device.

    python -m boofcv_tpu_torch.examples.associate_points [--device cpu|cuda]
"""

from __future__ import annotations

import numpy as np
import torch

from boofcv_tpu_torch._config import resolve_device
from boofcv_tpu_torch.examples import parse_device
from boofcv_tpu_torch.feature import associate, describe, fasthessian
from boofcv_tpu_torch.io import simulate
from boofcv_tpu_torch.ip import integral

DY, DX = 7, 12


def _scene():
    """Two 240x240 crops of one texture, the second (DY, DX) further in."""
    rng = np.random.default_rng(1)
    tex = simulate.noise_texture(rng, size=300, octaves=5)
    img1 = tex[:240, :240].astype(np.float32) * 255
    img2 = tex[DY:240 + DY, DX:240 + DX].astype(np.float32) * 255
    return img1, img2


def main(argv=None) -> int:
    dev = resolve_device(parse_device(argv))
    img1, img2 = _scene()

    def detect_describe(img):
        ii = integral.transform(torch.as_tensor(img, device=dev))
        det = fasthessian.detect(ii, max_features=150, threshold=1e3)
        angles = describe.orientation_average_haar(
            ii, det.ys, det.xs, det.scales)
        return det, describe.surf(ii, det.ys, det.xs, det.scales, angles)

    d1, f1 = detect_describe(img1)
    d2, f2 = detect_describe(img2)
    m = associate.associate_mutual(associate.score_euclidean_sq(f1, f2),
                                   max_error=0.2)
    h = lambda x: x.cpu().numpy()
    idx_a, idx_b = h(m.src), h(m.dst)
    valid = h(m.valid) & h(d1.valid)[idx_a] & h(d2.valid)[idx_b]
    y1 = h(d1.ys)[idx_a][valid]
    x1 = h(d1.xs)[idx_a][valid]
    y2 = h(d2.ys)[idx_b][valid]
    x2 = h(d2.xs)[idx_b][valid]
    print(f"device: {dev}")
    # ground truth: features move by (-DY, -DX) in image 2's coordinates
    good = (np.abs((y2 - y1) + DY) < 2.0) & (np.abs((x2 - x1) + DX) < 2.0)
    n = int(valid.sum())
    print(f"detected {int(h(d1.valid).sum())} /"
          f" {int(h(d2.valid).sum())} SURF features")
    print(f"matches: {n}, consistent with the known shift: {int(good.sum())}")
    ok = n >= 20 and good.mean() > 0.8
    print("OK" if ok else "FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
