"""Line segments with the grid-RANSAC detector (port of
``boofcv_tpu/examples/line_segments_ransac.py``).

Reference analog: examples/features/ExampleLineRansac.java
(GridRansacLineDetector) — gradient pixels grouped per grid region, lines
RANSAC-fit per region, then connected.  Oracle: a rendered triangle's
three edges come back at their angles.

    python -m boofcv_tpu_torch.examples.line_segments_ransac [--device cpu|cuda]
"""

from __future__ import annotations

import numpy as np
import torch

from boofcv_tpu_torch._config import resolve_device
from boofcv_tpu_torch.examples import parse_device
from boofcv_tpu_torch.feature import lines


def main(argv=None) -> int:
    dev = resolve_device(parse_device(argv))
    rng = np.random.default_rng(3)
    img = np.full((160, 200), 40.0, np.float32)
    yy, xx = np.mgrid[0:160, 0:200]
    # a filled triangle: edges at 0 deg (bottom), ~63 deg, ~-63 deg
    inside = ((yy < 130) & (yy > 130 - 2 * (xx - 40))
              & (yy > 130 - 2 * (160 - xx)))
    img[inside] = 210.0
    img += rng.normal(0, 2.5, img.shape).astype(np.float32)

    segs = lines.grid_ransac_lines(torch.as_tensor(img, device=dev),
                                   region_size=32, edge_threshold=30.0,
                                   generator=torch.Generator(
                                       device=dev).manual_seed(0))
    valid = segs.valid.cpu().numpy()
    x0, y0, x1, y1 = [getattr(segs, f).cpu().numpy()[valid]
                      for f in ("x0", "y0", "x1", "y1")]
    keep = np.hypot(x1 - x0, y1 - y0) > 12
    angles = np.degrees(np.arctan2(y1 - y0, x1 - x0))[keep] % 180.0

    def count_near(target, tol=8.0):
        d = np.abs(angles - target)
        return int((np.minimum(d, 180 - d) < tol).sum())
    n_flat, n_up, n_dn = count_near(0.0), count_near(63.4), count_near(
        180 - 63.4)
    merged = lines.connect_segments(segs)
    print(f"device: {dev}")
    print(f"segments: {len(angles)}, connected into {len(merged.x0)}")
    print(f"angle groups: horizontal {n_flat}, +63deg {n_up}, "
          f"-63deg {n_dn}")
    ok = n_flat >= 1 and n_up >= 1 and n_dn >= 1
    print("OK" if ok else "FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
