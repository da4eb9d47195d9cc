"""Graph-based image segmentation, Felzenszwalb-Huttenlocher 2004 (port of
``boofcv_tpu/examples/segment_graph_fh04.py``).

Reference analog: examples/segmentation/ExampleSegmentImage.java with
SegmentFelzenszwalbHuttenlocher04 — edge weights on the device, the
sorted-edge union-find merge in the native library on the host.  Oracle:
three flat bands with noise segment into three dominant regions, one a
band.

    python -m boofcv_tpu_torch.examples.segment_graph_fh04 [--device cpu|cuda]
"""

from __future__ import annotations

import numpy as np
import torch

from boofcv_tpu_torch._config import resolve_device
from boofcv_tpu_torch.examples import parse_device
from boofcv_tpu_torch.feature import segmentation


def main(argv=None) -> int:
    dev = resolve_device(parse_device(argv))
    rng = np.random.default_rng(1)
    img = np.zeros((90, 120), np.float32)
    img[:, :40] = 60.0
    img[:, 40:80] = 140.0
    img[:, 80:] = 220.0
    img += rng.normal(0, 4.0, img.shape).astype(np.float32)

    labels, n = segmentation.segment_fh04(torch.as_tensor(img, device=dev),
                                          k=200.0, min_size=50)
    sizes = np.bincount(labels.ravel())
    big = np.argsort(sizes)[::-1][:3]
    bands = (np.s_[:, :40], np.s_[:, 40:80], np.s_[:, 80:])
    # each big segment should live inside exactly one band
    purity = [max(np.isin(labels[s], [b]).mean() for s in bands)
              for b in big]
    print(f"device: {dev}")
    print(f"segments: {n} (3 dominant cover "
          f"{sizes[big].sum() / labels.size:.0%}); band purity "
          f"{[round(p, 2) for p in purity]}")
    ok = sizes[big].sum() > 0.95 * labels.size and all(p > 0.9
                                                       for p in purity)
    print("OK" if ok else "FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
