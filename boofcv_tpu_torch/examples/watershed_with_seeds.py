"""Marker-controlled watershed segmentation (port of
``boofcv_tpu/examples/watershed_with_seeds.py``).

Reference analog: examples/segmentation/ExampleWatershedWithSeeds.java —
seed markers flood the gradient "height map" so each pixel joins a seed's
basin.  Oracle: two rendered disks with their own seeds segment into two
regions the size of the disks.

    python -m boofcv_tpu_torch.examples.watershed_with_seeds [--device cpu|cuda]
"""

from __future__ import annotations

import numpy as np
import torch

from boofcv_tpu_torch._config import resolve_device
from boofcv_tpu_torch.examples import parse_device
from boofcv_tpu_torch.feature import segmentation
from boofcv_tpu_torch.ip import derivative


def main(argv=None) -> int:
    dev = resolve_device(parse_device(argv))
    rng = np.random.default_rng(2)
    img = np.full((120, 160), 30.0, np.float32)
    yy, xx = np.mgrid[0:120, 0:160]
    disk1 = (yy - 55) ** 2 + (xx - 50) ** 2 < 30 ** 2
    disk2 = (yy - 60) ** 2 + (xx - 112) ** 2 < 26 ** 2
    img[disk1] = 200.0
    img[disk2] = 150.0
    img += rng.normal(0, 2.0, img.shape).astype(np.float32)

    dx, dy = derivative.sobel(torch.as_tensor(img, device=dev))
    markers = np.zeros((120, 160), np.int32)
    markers[55, 50] = 1          # a seed inside disk 1
    markers[60, 112] = 2         # a seed inside disk 2
    markers[5, 5] = 3            # a background seed
    labels = segmentation.watershed(torch.hypot(dx, dy),
                                    torch.as_tensor(markers, device=dev))
    labels = labels.cpu().numpy()
    iou1 = (disk1 & (labels == 1)).sum() / (disk1 | (labels == 1)).sum()
    iou2 = (disk2 & (labels == 2)).sum() / (disk2 | (labels == 2)).sum()
    print(f"device: {dev}")
    print(f"region sizes: {(labels == 1).sum()}, {(labels == 2).sum()} px "
          f"(true {disk1.sum()}, {disk2.sum()}); IoU {iou1:.2f}, "
          f"{iou2:.2f}")
    ok = iou1 > 0.85 and iou2 > 0.85 and (labels > 0).all()
    print("OK" if ok else "FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
