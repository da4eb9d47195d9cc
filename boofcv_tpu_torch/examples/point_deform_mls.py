"""Point-controlled image deformation (moving least squares) (port of
``boofcv_tpu/examples/point_deform_mls.py``).

Reference analog: examples/imageprocessing/ExamplePointDeformKeyPoints .java
— drag control points, warp the image with MLS (Schaefer 2006). Oracle:
fixed control points stay fixed; a dragged point carries its image content
with it. The JAX example's ``--tpu`` flag and ``setup_backend`` have no
counterpart: ``--device`` picks the device.

    python -m boofcv_tpu_torch.examples.point_deform_mls [--device cpu|cuda]
"""

from __future__ import annotations

import numpy as np
import torch
from scipy.ndimage import gaussian_filter

from boofcv_tpu_torch._config import resolve_device
from boofcv_tpu_torch.examples import parse_device
from boofcv_tpu_torch.ip import interpolate, mls

# corners pinned, centre dragged 18 px right / 10 px down
SRC = np.array([[20, 20], [140, 20], [140, 100], [20, 100], [80, 60]],
               np.float64)
DST = SRC.copy()
DST[4] = [98, 70]


def _scene():
    """A smooth random texture (sigma-2.5 filtered noise), 120x160."""
    rng = np.random.default_rng(1)
    img = gaussian_filter(rng.normal(0, 1, (120, 160)), 2.5)
    return (120 + 70 * img / img.std()).astype(np.float32)


def main(argv=None) -> int:
    dev = resolve_device(parse_device(argv))
    img = _scene()
    out_t = mls.deform(img, SRC, DST, kind="similarity", device=dev)
    out = out_t.cpu().numpy()
    # pinned corners keep their local content
    errs_pin = [np.abs(out[y - 3:y + 4, x - 3:x + 4]
                       - img[y - 3:y + 4, x - 3:x + 4]).mean()
                for x, y in SRC[:4].astype(int)]
    # the dragged point's new location shows the source content
    val_dst = float(interpolate.bilinear(
        out_t, torch.tensor([70.0], device=dev),
        torch.tensor([98.0], device=dev))[0])
    val_src = img[60, 80]
    print(f"device: {dev}")
    print(f"pinned-corner mean err {np.mean(errs_pin):.2f}; dragged "
          f"content |diff| {abs(val_dst - val_src):.1f} (image std "
          f"{img.std():.0f})")
    ok = np.mean(errs_pin) < 6.0 and abs(val_dst - val_src) < 15.0
    print("OK" if ok else "FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
