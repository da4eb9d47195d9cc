"""Find images with similar color content via color histograms (port of
``boofcv_tpu/examples/color_histogram_lookup.py``).

Reference analog: examples/imageprocessing/ExampleColorHistogramLookup.java
— images are summarized as (coupled) hue-saturation histograms and ranked by
histogram distance against a query.  Multi-band processing rides the
``ip.planar`` vmap-over-bands layer; the 2-D histogram is one scatter-add.
The JAX example's ``--tpu`` flag and ``setup_backend`` have no counterpart:
``--device`` picks the device.

    python -m boofcv_tpu_torch.examples.color_histogram_lookup [--device cpu|cuda]
"""

from __future__ import annotations

import numpy as np
import torch

from boofcv_tpu_torch._config import resolve_device
from boofcv_tpu_torch.examples import parse_device
from boofcv_tpu_torch.ip import blur, color, planar

BASES = [(200, 40, 40), (40, 180, 60), (50, 70, 210), (210, 200, 60),
         (140, 60, 160)]


def _patch(base_rgb, seed):
    """A 48x64 patch of one colour with sigma-12 noise, clipped."""
    r = np.random.default_rng(seed)
    img = np.tile(np.asarray(base_rgb, np.float32), (48, 64, 1))
    img += r.normal(0, 12, img.shape)
    return np.clip(img, 0, 255)


def _hs_hist(img, nb=12):
    """Normalised hue-saturation histogram of an RGB image."""
    hsv = color.rgb_to_hsv(img / 255.0)
    h, s = hsv[..., 0], hsv[..., 1]
    hb = torch.clamp((h / (2 * np.pi) * nb).to(torch.int32), 0, nb - 1)
    sb = torch.clamp((s * nb).to(torch.int32), 0, nb - 1)
    flat = (hb * nb + sb).reshape(-1).long()
    hist = torch.bincount(flat, minlength=nb * nb).to(torch.float32)
    return hist / torch.sum(hist)


def main(argv=None) -> int:
    dev = resolve_device(parse_device(argv))
    on = lambda a: torch.as_tensor(a, device=dev)
    blurred = lambda img: planar.planar(blur.gaussian)(img, sigma=1.5)
    # planar blur (one call over the 3 bands)
    gallery = [blurred(on(_patch(b, i))) for i, b in enumerate(BASES)]
    hists = torch.stack([_hs_hist(g) for g in gallery])
    correct = 0
    for q in range(len(BASES)):
        qh = _hs_hist(blurred(on(_patch(BASES[q], 100 + q))))
        d = torch.sum(torch.abs(hists - qh[None]), dim=1)   # L1 distance
        correct += int(torch.argmin(d)) == q
    print(f"device: {dev}")
    print(f"query->gallery matches: {correct}/{len(BASES)}")
    ok = correct == len(BASES)
    print("OK" if ok else "FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
