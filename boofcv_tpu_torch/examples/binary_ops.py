"""Binary image operations: threshold, morphology, labeling, contours (port of
``boofcv_tpu/examples/binary_ops.py``).

Reference analog: examples/imageprocessing/ExampleBinaryOps.java — threshold
-> erode/dilate -> connected components -> contours.  Oracle: three noisy
blobs survive cleanup as exactly three labeled components with closed
external contours. The JAX example's ``--tpu`` flag and ``setup_backend``
have no counterpart: ``--device`` picks the device.

    python -m boofcv_tpu_torch.examples.binary_ops [--device cpu|cuda]
"""

from __future__ import annotations

import numpy as np
import torch

from boofcv_tpu_torch._config import resolve_device
from boofcv_tpu_torch.examples import parse_device
from boofcv_tpu_torch.ip import binary, threshold


def _scene():
    """Three dark disks on bright paper with sigma-12 noise."""
    rng = np.random.default_rng(7)
    img = np.full((120, 160), 220.0, np.float32)
    yy, xx = np.mgrid[0:120, 0:160]
    for cy, cx, r in ((35, 40, 16), (35, 115, 12), (85, 75, 20)):
        img[(yy - cy) ** 2 + (xx - cx) ** 2 < r * r] = 30.0
    img += rng.normal(0, 12, img.shape)               # salt noise
    return img


def main(argv=None) -> int:
    dev = resolve_device(parse_device(argv))
    img = torch.as_tensor(_scene(), device=dev)
    t = float(threshold.compute_otsu(img, 0.0, 255.0))
    bw = threshold.threshold(img, t, down=True)
    n_raw = binary.label_blobs_host(bw.cpu().numpy())[1]
    clean = binary.dilate4(binary.erode4(binary.erode4(
        binary.dilate4(bw))))                          # close then open
    clean = clean.cpu().numpy()
    labels, n = binary.label_blobs_host(clean)
    contours = binary.contour_external(clean)
    print(f"device: {dev}")
    big = [c for c in contours if len(c) > 20]
    print(f"otsu threshold {t:.0f}; components raw {n_raw} -> "
          f"cleaned {n}; contours {len(big)} (expected 3)")
    perims = sorted(len(c) for c in big)
    ok = n == 3 and len(big) == 3 and perims[0] > 40
    print("OK" if ok else "FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
