"""Corner detection: intensity operators + non-maximum suppression (port of
``boofcv_tpu/examples/corner_features.py``).

Reference analog: examples/features/ExampleCornerFeature.java +
ExampleInterestPoint.java + ExampleNonMaximumSupression.java — Shi-Tomasi /
Harris / FAST intensities through block nonmax + top-K select.  Oracle: a
rendered checkerboard's interior crossings are found by the gradient
operators; FAST finds the 4 corners of a bright square. The JAX example's
``--tpu`` flag and ``setup_backend`` have no counterpart: ``--device`` picks
the device.

    python -m boofcv_tpu_torch.examples.corner_features [--device cpu|cuda]
"""

from __future__ import annotations

import numpy as np
import torch

from boofcv_tpu_torch._config import resolve_device
from boofcv_tpu_torch.examples import parse_device
from boofcv_tpu_torch.feature import extract, intensity

SQ = 20
CROSSINGS = [(r * SQ - 0.5, c * SQ - 0.5)
             for r in range(1, 6) for c in range(1, 8)]
SQUARE_CORNERS = [(25, 35), (25, 74), (54, 35), (54, 74)]


def _scene():
    """(checkerboard 120x160 with 20 px squares, bright square on dark
    80x100)."""
    board = np.zeros((120, 160), np.float32)
    yy, xx = np.mgrid[0:120, 0:160]
    board[((yy // SQ) + (xx // SQ)) % 2 == 0] = 200.0
    sq_img = np.zeros((80, 100), np.float32)
    sq_img[25:55, 35:75] = 220.0
    return board, sq_img


def _found(det):
    valid = det.valid.cpu().numpy()
    return det.ys.cpu().numpy()[valid], det.xs.cpu().numpy()[valid]


def main(argv=None) -> int:
    dev = resolve_device(parse_device(argv))
    board, sq_img = _scene()
    board = torch.as_tensor(board, device=dev)
    print(f"device: {dev}")
    results = {}
    for name, fn in (("shi-tomasi",
                      lambda im: intensity.shi_tomasi(im, radius=2)),
                     ("harris",
                      lambda im: intensity.harris(im, radius=2))):
        ys, xs = _found(extract.detect(fn(board), max_features=40, radius=5,
                                       threshold=1.0, border=6))
        hits = 0
        for cy, cx in CROSSINGS:
            d = np.hypot(ys - cy, xs - cx)
            hits += int(len(d) > 0 and d.min() < 3.0)
        results[name] = (hits, len(ys))
        print(f"{name:10s}: {hits}/{len(CROSSINGS)} crossings hit "
              f"({len(ys)} detections)")
    # FAST: a bright square on dark (saddles have two 8-runs, not 9)
    f_inten, is_corner = intensity.fast(torch.as_tensor(sq_img, device=dev))
    ys, xs = _found(extract.detect(torch.where(is_corner, f_inten, 0.0),
                                   max_features=10, radius=4,
                                   threshold=10.0, border=3))
    fast_hits = sum(int(np.hypot(ys - cy, xs - cx).min() < 3.0)
                    for cy, cx in SQUARE_CORNERS if len(ys))
    print(f"fast9     : {fast_hits}/4 square corners ({len(ys)} detections)")
    ok = (results["shi-tomasi"][0] >= 30 and results["harris"][0] >= 30
          and fast_hits == 4)
    print("OK" if ok else "FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
