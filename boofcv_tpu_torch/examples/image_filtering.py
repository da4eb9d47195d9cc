"""Image filtering basics: blur, derivatives, binary ops, thresholding (port of
``boofcv_tpu/examples/image_filtering.py``).

Reference analogs: examples/imageprocessing/ExampleImageFilter.java,
ExampleImageBlur.java, ExampleImageDerivative.java, ExampleBinaryOps.java
and examples/segmentation/ExampleThresholding.java — one tour of the boofcv-
ip layer with checkable invariants. The JAX example's ``--tpu`` flag and
``setup_backend`` have no counterpart: ``--device`` picks the device.

    python -m boofcv_tpu_torch.examples.image_filtering [--device cpu|cuda]
"""

from __future__ import annotations

import numpy as np
import torch

from boofcv_tpu_torch._config import resolve_device
from boofcv_tpu_torch.examples import parse_device
from boofcv_tpu_torch.ip import binary, blur, derivative, threshold


def _scene():
    """A bright rectangle on a dark background, sigma-4 noise."""
    rng = np.random.default_rng(15)
    img = np.full((96, 128), 40.0, np.float32)
    img[20:60, 30:80] = 200.0                      # bright rectangle
    img += rng.normal(0, 4, img.shape)
    return img


def main(argv=None) -> int:
    dev = resolve_device(parse_device(argv))
    img = _scene()
    timg = torch.as_tensor(img, device=dev)
    print(f"device: {dev}")
    ok = True
    # blur reduces noise variance but keeps the mean
    g = blur.gaussian(timg, sigma=2.0)
    m = blur.mean(timg, radius=3).cpu().numpy()
    med = blur.median(timg, radius=2).cpu().numpy()
    for name, out in [("gaussian", g.cpu().numpy()), ("mean", m),
                      ("median", med)]:
        flat = out[70:90, 90:120]
        print(f"{name:9s} blur: flat-region std {flat.std():.2f} "
              f"(input {img[70:90, 90:120].std():.2f})")
        ok &= flat.std() < img[70:90, 90:120].std()
    # sobel responds on the rectangle's edges, not inside
    gx, gy = derivative.sobel(g)
    mag = (torch.abs(gx) + torch.abs(gy)).cpu().numpy()
    edge = mag[18:62, 28:82].max()
    interior = mag[35:50, 45:65].mean()
    print(f"sobel: edge response {edge:.0f}, interior {interior:.1f}")
    ok &= edge > 20 * max(interior, 1e-3)
    # Otsu threshold + morphology + blob count
    t = threshold.compute_otsu(timg, float(img.min()), float(img.max()))
    bw = threshold.threshold(timg, t, down=False)   # bright blob
    bw = binary.erode4(binary.dilate4(bw))
    contours = binary.contour_external(bw.cpu().numpy().astype(np.uint8))
    print(f"otsu threshold {float(t):.0f}; blobs found: {len(contours)}")
    ok &= len(contours) == 1
    print("OK" if ok else "FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
