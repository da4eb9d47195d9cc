"""Global vs adaptive thresholding under uneven illumination (port of
``boofcv_tpu/examples/thresholding_techniques.py``).

Reference analog: examples/imageprocessing/ExampleThresholding.java —
global/Otsu breaks under an illumination gradient while local
(mean/Sauvola/block) techniques recover the shapes.  Oracle: IoU of the
recovered dark text-like shapes against ground truth. The JAX example's
``--tpu`` flag and ``setup_backend`` have no counterpart: ``--device`` picks
the device.

    python -m boofcv_tpu_torch.examples.thresholding_techniques [--device cpu|cuda]
"""

from __future__ import annotations

import numpy as np
import torch

from boofcv_tpu_torch._config import resolve_device
from boofcv_tpu_torch.examples import parse_device
from boofcv_tpu_torch.ip import threshold


def _scene():
    """(image [120, 200] float64, truth mask): dark glyph blocks on paper
    under a strong illumination ramp, sigma-3 noise."""
    rng = np.random.default_rng(9)
    h, w = 120, 200
    yy, xx = np.mgrid[0:h, 0:w]
    truth = np.zeros((h, w), bool)
    for (cy, cx) in [(30, 30), (30, 100), (30, 170), (85, 60), (85, 140)]:
        truth |= (np.abs(yy - cy) < 12) & (np.abs(xx - cx) < 14) \
            & ((yy + xx) % 7 < 5)
    illum = 90 + 140 * xx / w
    img = np.where(truth, 0.35, 1.0) * illum
    img += rng.normal(0, 3, img.shape)
    return img, truth


def main(argv=None) -> int:
    dev = resolve_device(parse_device(argv))
    img, truth = _scene()
    timg = torch.as_tensor(img, dtype=torch.float32, device=dev)

    def iou(mask):
        m = mask.cpu().numpy() > 0
        return (m & truth).sum() / max((m | truth).sum(), 1)

    t_otsu = float(threshold.compute_otsu(timg, float(img.min()),
                                          float(img.max())))
    scores = {"global-otsu": iou(threshold.threshold(timg, t_otsu,
                                                     down=True)),
              "local-mean": iou(threshold.local_mean(timg, radius=20)),
              "sauvola": iou(threshold.sauvola(timg, radius=20, k=0.3)),
              "block-min-max": iou(threshold.block_min_max(timg,
                                                           block_size=24))}
    print(f"device: {dev}")
    for k, v in scores.items():
        print(f"{k:14s} IoU {v:.2f}")
    ok = (scores["local-mean"] > 0.8 and scores["sauvola"] > 0.8
          and scores["block-min-max"] > 0.6
          and scores["global-otsu"] < scores["sauvola"] - 0.1)
    print("OK" if ok else "FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
