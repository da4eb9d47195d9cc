"""Fit polygons and ellipses to binary blobs (port of
``boofcv_tpu/examples/fit_shapes.py``).

Reference analog: examples/features/ExampleFitPolygon.java +
ExampleFitEllipse.java — threshold, trace contours, fit shapes. Oracle: a
rendered rectangle comes back as a 4-gon with correct corners; a rendered
ellipse's center/axes are recovered. The JAX example's ``--tpu`` flag and
``setup_backend`` have no counterpart: ``--device`` picks the device.

    python -m boofcv_tpu_torch.examples.fit_shapes [--device cpu|cuda]
"""

from __future__ import annotations

import numpy as np
import torch

from boofcv_tpu_torch._config import resolve_device
from boofcv_tpu_torch.examples import parse_device
from boofcv_tpu_torch.feature import shapes
from boofcv_tpu_torch.ip import binary, threshold

RECT = np.array([[30, 25], [109, 25], [109, 74], [30, 74]], float)


def _scene():
    """A dark rectangle and a dark ellipse on bright paper, sigma-2 noise."""
    img = np.full((140, 200), 230.0, np.float32)
    img[25:75, 30:110] = 25.0                      # rectangle
    yy, xx = np.mgrid[0:140, 0:200].astype(np.float64)
    ell = ((xx - 155) / 28.0) ** 2 + ((yy - 85) / 16.0) ** 2 <= 1.0
    img[ell] = 25.0
    img += np.random.default_rng(0).normal(0, 2.0, img.shape)
    return img


def main(argv=None) -> int:
    dev = resolve_device(parse_device(argv))
    bw = threshold.threshold(torch.as_tensor(_scene(), device=dev), 128.0,
                             down=True)
    contours = binary.contour_external(bw.cpu().numpy())
    print(f"device: {dev}")
    polys, ells = [], []
    for c in contours:
        if len(c) < 30:
            continue
        polys.append(shapes.fit_polygon(c, num_sides=4))
        ells.append(shapes.fit_ellipse(c))
    print(f"blobs: {len(polys)}")
    rect_ok = ell_ok = False
    for p, e in zip(polys, ells):
        if p is not None and len(p) == 4:
            corners = np.asarray(p, float)
            d = np.linalg.norm(corners[:, None] - RECT[None], axis=-1)
            if d.min(axis=1).max() < 3.0:
                rect_ok = True
                print(f"rectangle 4-gon corners within "
                      f"{d.min(axis=1).max():.1f} px")
        if e is not None:
            cx, cy = e["center"]
            if abs(cx - 155) < 2 and abs(cy - 85) < 2 \
                    and abs(e["a"] - 28) < 3 and abs(e["b"] - 16) < 3:
                ell_ok = True
                print(f"ellipse center ({cx:.1f}, {cy:.1f}) axes "
                      f"({e['a']:.1f}, {e['b']:.1f})")
    ok = rect_ok and ell_ok
    print("OK" if ok else "FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
