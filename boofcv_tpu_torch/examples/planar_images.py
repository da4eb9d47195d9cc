"""Working with multi-band (Planar) images (port of
``boofcv_tpu/examples/planar_images.py``).

Reference analog: examples/imageprocessing/ExamplePlanarImages.java — split
an interleaved color image into bands, process per band (one vmap on TPU),
merge back.  Oracle: planar blur equals per-band blur; band math (swap
red/blue) round-trips. The JAX example's ``--tpu`` flag and
``setup_backend`` have no counterpart: ``--device`` picks the device.

    python -m boofcv_tpu_torch.examples.planar_images [--device cpu|cuda]
"""

from __future__ import annotations

import numpy as np
import torch

from boofcv_tpu_torch._config import resolve_device
from boofcv_tpu_torch.examples import parse_device
from boofcv_tpu_torch.ip import blur, planar


def _scene():
    rng = np.random.default_rng(4)
    return rng.uniform(0, 255, (60, 80, 3)).astype(np.float32)


def main(argv=None) -> int:
    dev = resolve_device(parse_device(argv))
    rgb = torch.as_tensor(_scene(), device=dev)
    bands = planar.split_bands(rgb)
    assert len(bands) == 3
    swapped = planar.merge_bands([bands[2], bands[1], bands[0]])
    back = planar.merge_bands(planar.split_bands(swapped)[::-1])
    round_ok = bool(torch.equal(back, rgb))
    blurred = planar.planar(blur.gaussian)(rgb, sigma=1.5)
    ref = torch.stack([blur.gaussian(rgb[..., c], sigma=1.5)
                       for c in range(3)], dim=-1)
    blur_err = float(torch.abs(blurred - ref).max())
    gray = planar.average_bands(rgb)
    print(f"device: {dev}")
    print(f"split/merge round-trip: {round_ok}; planar-blur vs "
          f"band-loop max err {blur_err:.2e}; gray mean "
          f"{float(gray.mean()):.1f} (bands mean "
          f"{float(rgb.mean()):.1f})")
    ok = round_ok and blur_err < 1e-4 \
        and abs(float(gray.mean() - rgb.mean())) < 1e-3
    print("OK" if ok else "FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
