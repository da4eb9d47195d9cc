"""Detect lines with the Hough transform (port of
``boofcv_tpu/examples/line_detection.py``).

Reference analog: examples/features/ExampleLineDetection.java — Hough from
the gradient image (polar parameterization) finding the dominant straight
edges of a rendered rectangle. The JAX example's ``--tpu`` flag and
``setup_backend`` have no counterpart: ``--device`` picks the device.

    python -m boofcv_tpu_torch.examples.line_detection [--device cpu|cuda]
"""

from __future__ import annotations

import numpy as np

from boofcv_tpu_torch._config import resolve_device
from boofcv_tpu_torch.examples import parse_device
from boofcv_tpu_torch.feature import lines


def _scene():
    """A bright rectangle (four edges) on dark, sigma-3 noise."""
    rng = np.random.default_rng(17)
    img = np.full((120, 160), 30.0, np.float32)
    img[30:90, 40:120] = 220.0                     # rectangle: 4 edges
    img += rng.normal(0, 3, img.shape)
    return img


def main(argv=None) -> int:
    dev = resolve_device(parse_device(argv))
    found = lines.hough_gradient(_scene(), max_lines=6, edge_threshold=40.0,
                                 device=dev)
    theta = found.theta.cpu().numpy()
    valid = found.valid.cpu().numpy()
    n = int(valid.sum())
    print(f"device: {dev}")
    print(f"hough (gradient/polar): {n} lines")
    # expect two ~horizontal and two ~vertical lines
    th = np.mod(theta[valid], np.pi)
    horiz = np.sum((np.abs(th - np.pi / 2) < 0.15))
    vert = np.sum((th < 0.15) | (th > np.pi - 0.15))
    print(f"~horizontal: {horiz}, ~vertical: {vert}")
    ok = n >= 4 and horiz >= 2 and vert >= 2
    print("OK" if ok else "FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
