"""Canny edge detection on synthetic shapes (port of
``boofcv_tpu/examples/canny_edge.py``).

Reference analog: examples/imageprocessing/ExampleCannyEdge.java — dynamic-
threshold Canny producing a binary edge mask plus traced edge contours.  The
oracle: a rendered disk and rectangle must yield thin, closed edge chains
hugging the true boundaries. The JAX example's ``--tpu`` flag and
``setup_backend`` have no counterpart: ``--device`` picks the device.

    python -m boofcv_tpu_torch.examples.canny_edge [--device cpu|cuda]
"""

from __future__ import annotations

import numpy as np

from boofcv_tpu_torch._config import resolve_device
from boofcv_tpu_torch.examples import parse_device
from boofcv_tpu_torch.feature.canny import canny, edge_contours


def _scene():
    """A bright rectangle and a disk on a dark background, sigma-2 noise."""
    rng = np.random.default_rng(3)
    img = np.full((160, 200), 40.0, np.float32)
    img[20:70, 120:180] = 200.0                     # rectangle
    yy, xx = np.mgrid[0:160, 0:200]
    img[(yy - 100) ** 2 + (xx - 60) ** 2 < 35 ** 2] = 180.0   # disk
    img += rng.normal(0, 2.0, img.shape)
    return img


def _near_boundary(x, y):
    on_rect = (19 <= y <= 70 and 119 <= x <= 180) and (
        min(abs(y - 19.5), abs(y - 69.5), abs(x - 119.5),
            abs(x - 179.5)) < 3)
    r = np.hypot(y - 100, x - 60)
    return on_rect or abs(r - 35) < 3


def main(argv=None) -> int:
    dev = resolve_device(parse_device(argv))
    mask = canny(_scene(), 0.1, 0.4, relative=True, device=dev).cpu().numpy()
    chains = edge_contours(mask)
    print(f"device: {dev}")
    big = [c for c in chains if len(c) > 40]
    print(f"edge pixels: {int(mask.sum())}, chains: {len(chains)} "
          f"({len(big)} long)")
    # every long-chain point must lie near one of the true boundaries
    frac_good = np.mean([_near_boundary(x, y) for c in big for x, y in c])
    # the two shapes produce one long chain each
    print(f"long-chain boundary fraction: {frac_good:.3f}")
    ok = len(big) >= 2 and frac_good > 0.97 and mask.sum() > 300
    print("OK" if ok else "FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
