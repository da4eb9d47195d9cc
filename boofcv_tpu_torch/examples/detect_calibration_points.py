"""Detect calibration-target points: chessboard, square grid, circle grid
(port of ``boofcv_tpu/examples/detect_calibration_points.py``).

Reference analog: examples/calibration/ExampleDetectCalibrationPoints.java
— run each target detector on a rendered target and report the ordered
calibration points.

    python -m boofcv_tpu_torch.examples.detect_calibration_points [--device cpu|cuda]
"""

from __future__ import annotations

import numpy as np

from boofcv_tpu_torch._config import resolve_device
from boofcv_tpu_torch.examples import parse_device
from boofcv_tpu_torch.recognition import calib_targets, chessboard


def main(argv=None) -> int:
    dev = resolve_device(parse_device(argv))
    rng = np.random.default_rng(20)
    ok = True
    print(f"device: {dev}")

    # chessboard (unknown size, connectivity assembly)
    sq = 24
    img = np.full((220, 260), 128.0, np.float32)
    for r in range(6):
        for c in range(7):
            if (r + c) % 2 == 0:
                img[30 + r * sq:30 + (r + 1) * sq,
                    26 + c * sq:26 + (c + 1) * sq] = 30.0
            else:
                img[30 + r * sq:30 + (r + 1) * sq,
                    26 + c * sq:26 + (c + 1) * sq] = 220.0
    img += rng.normal(0, 2, img.shape)
    out = chessboard.detect_chessboard_auto(img, device=dev)
    n = 0 if out is None else int(out[1].sum())
    print(f"chessboard: {n} corners "
          f"(grid {None if out is None else out[0].shape[:2]})")
    ok &= out is not None and n >= 29 and out[0].shape[:2] in \
        ((5, 6), (6, 5))

    # square grid (3x4 black squares -> 2*3 x 2*4 corner lattice)
    img = np.full((200, 240), 220.0, np.float32)
    for r in range(3):
        for c in range(4):
            y0, x0 = 35 + r * 50, 25 + c * 52
            img[y0:y0 + 26, x0:x0 + 26] = 25.0
    img += rng.normal(0, 2, img.shape)
    pts = calib_targets.detect_square_grid(img, rows=3, cols=4, device=dev)
    print(f"square grid: {0 if pts is None else len(pts)} corners")
    ok &= pts is not None and len(pts) == 4 * 3 * 4

    # regular circle grid (4x5)
    img = np.full((200, 240), 220.0, np.float32)
    yy, xx = np.mgrid[0:200, 0:240]
    for r in range(4):
        for c in range(5):
            cy, cx = 40 + r * 40, 40 + c * 40
            img[(yy - cy) ** 2 + (xx - cx) ** 2 < 11 ** 2] = 25.0
    img += rng.normal(0, 2, img.shape)
    centers = calib_targets.detect_circle_regular_grid(img, rows=4, cols=5,
                                                       device=dev)
    print(f"circle grid: {0 if centers is None else len(centers)} centers")
    ok &= centers is not None and len(centers) == 20

    print("OK" if ok else "FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
