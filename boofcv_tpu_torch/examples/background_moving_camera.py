"""Background subtraction from a moving (panning) camera (port of
``boofcv_tpu/examples/background_moving_camera.py``).

Reference analog: examples/segmentation/ExampleBackgroundRemovalMoving
.java — the background model lives in a "home" frame; each frame is
registered to it by a homography (here the known pan; in the reference a
tracker estimates it) before update and segment.  Oracle: a moving blob is
segmented while the camera pans over a static textured scene.

    python -m boofcv_tpu_torch.examples.background_moving_camera [--device cpu|cuda]
"""

from __future__ import annotations

import numpy as np
from scipy.ndimage import gaussian_filter

from boofcv_tpu_torch._config import resolve_device
from boofcv_tpu_torch.examples import parse_device
from boofcv_tpu_torch.feature import background as bg


def main(argv=None) -> int:
    dev = resolve_device(parse_device(argv))
    rng = np.random.default_rng(12)
    world = gaussian_filter(rng.normal(120, 25, (160, 260)).astype(
        np.float32), 2.0)
    H, W = 120, 160

    def frame(t, blob=None):
        ox = 8 * t                              # the camera pans right
        img = world[20:20 + H, ox:ox + W].copy()
        mask = np.zeros((H, W), bool)
        if blob is not None:
            yy, xx = np.mgrid[0:H, 0:W]
            mask = (yy - blob[0]) ** 2 + (xx - (blob[1] - ox)) ** 2 < 10 ** 2
            img[mask] = 240.0
        # home -> current: the pan, a pure translation
        return img, np.array([[1.0, 0, -ox], [0, 1.0, 0], [0, 0, 1.0]]), mask

    model = bg.moving_init((H, W + 8 * 6), device=dev)   # covers the pan
    # learn the background while panning over the empty scene
    for t in range(6):
        img, Hm, _ = frame(t)
        model = bg.moving_basic_update(model, img, Hm, learn_rate=0.4)
    # an object enters while the camera is mid-pan
    img, Hm, blob = frame(3, blob=(30, 95))
    seg = bg.moving_basic_segment(model, img, Hm, threshold=35.0).cpu()
    seg = seg.numpy()
    det = seg == 1
    iou = (det & blob).sum() / max((det | blob).sum(), 1)
    fp = (det & ~blob).mean()
    print(f"device: {dev}")
    print(f"moving-camera segmentation IoU {iou:.2f}, false-positive "
          f"rate {fp:.3f} (known pixels {np.mean(seg != 2):.2f})")
    ok = iou > 0.6 and fp < 0.02
    print("OK" if ok else "FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
