"""Superpixel segmentation (SLIC) and graph-based segmentation (FH04)
(port of ``boofcv_tpu/examples/segment_superpixels.py``).

Reference analog: examples/segmentation/ExampleSegmentSuperpixels.java —
segment an image into coherent regions.  A synthetic image of flat
regions is segmented; each superpixel should cover mostly one true region.

    python -m boofcv_tpu_torch.examples.segment_superpixels [--device cpu|cuda]
"""

from __future__ import annotations

import numpy as np
import torch

from boofcv_tpu_torch._config import resolve_device
from boofcv_tpu_torch.examples import parse_device
from boofcv_tpu_torch.feature import segmentation


def _purity(labels: np.ndarray, gt: np.ndarray) -> float:
    """Share of pixels whose segment's majority true region is their own."""
    agree = 0
    for s in np.unique(labels):
        agree += np.unique(gt[labels == s], return_counts=True)[1].max()
    return agree / labels.size


def main(argv=None) -> int:
    dev = resolve_device(parse_device(argv))
    rng = np.random.default_rng(12)
    h, w = 96, 128
    img = np.zeros((h, w), np.float32)
    gt = np.zeros((h, w), np.int32)
    img[:, :64] = 60.0
    img[:48, 64:] = 140.0
    gt[:48, 64:] = 1
    img[48:, 64:] = 220.0
    gt[48:, 64:] = 2
    img += rng.normal(0, 3, img.shape).astype(np.float32)
    image = torch.as_tensor(img, device=dev)

    labels = segmentation.slic(image, num_segments=64, iterations=8)
    labels = labels.cpu().numpy()
    purity = _purity(labels, gt)
    print(f"device: {dev}")
    print(f"SLIC: {len(np.unique(labels))} superpixels, region purity "
          f"{purity:.3f}")
    fl, _ = segmentation.segment_fh04(image, k=100.0, min_size=40)
    print(f"FH04: {len(np.unique(fl))} regions, region purity "
          f"{_purity(fl, gt):.3f}")
    ok = purity > 0.97
    print("OK" if ok else "FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
