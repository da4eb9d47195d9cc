"""Skeletonize thick binary shapes by morphological thinning (port of
``boofcv_tpu/examples/morphological_thinning.py``).

Reference analog: examples/imageprocessing/ExampleMorphologicalThinning.java
— threshold an image and iteratively thin it down to a 1-px skeleton. The
JAX example's ``--tpu`` flag and ``setup_backend`` have no counterpart:
``--device`` picks the device.

    python -m boofcv_tpu_torch.examples.morphological_thinning [--device cpu|cuda]
"""

from __future__ import annotations

import numpy as np
import torch

from boofcv_tpu_torch._config import resolve_device
from boofcv_tpu_torch.examples import parse_device
from boofcv_tpu_torch.ip import binary, threshold


def _scene():
    """A thick "T" and a ring on a grey background."""
    img = np.full((80, 120), 40.0, np.float32)
    img[10:20, 10:50] = 220.0      # T top bar
    img[10:70, 25:35] = 220.0      # T stem
    yy, xx = np.mgrid[0:80, 0:120]
    r = np.hypot(yy - 40, xx - 85)
    img[(r < 22) & (r > 10)] = 220.0
    return img


def main(argv=None) -> int:
    dev = resolve_device(parse_device(argv))
    mask_t = threshold.threshold(torch.as_tensor(_scene(), device=dev),
                                 128.0, down=False)
    sk = binary.thin(mask_t).cpu().numpy()
    mask = mask_t.cpu().numpy()
    print(f"device: {dev}")
    blocks = sk[:-1, :-1] & sk[1:, :-1] & sk[:-1, 1:] & sk[1:, 1:]
    _, n_before = binary.label_blobs_host(mask)
    _, n_after = binary.label_blobs_host(sk)
    print(f"foreground px: {int(mask.sum())} -> skeleton px: "
          f"{int(sk.sum())}, 2x2 blocks: {int(blocks.sum())}")
    print(f"components: {n_before} -> {n_after}")
    ok = (blocks.sum() == 0 and n_before == n_after == 2
          and 0 < sk.sum() < 0.35 * mask.sum()
          and int((sk & ~mask).sum()) == 0)
    print("OK" if ok else "FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
