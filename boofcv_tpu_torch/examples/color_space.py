"""Color space conversions and their round trips (port of
``boofcv_tpu/examples/color_space.py``).

Reference analog: examples/imageprocessing/ExampleColorSpace.java (+
ExampleRgbToGray) — RGB <-> HSV / YUV / LAB conversions.  Oracle: every
round trip reconstructs the input; hue of pure colors lands at the textbook
angles. The JAX example's ``--tpu`` flag and ``setup_backend`` have no
counterpart: ``--device`` picks the device.

    python -m boofcv_tpu_torch.examples.color_space [--device cpu|cuda]
"""

from __future__ import annotations

import numpy as np
import torch

from boofcv_tpu_torch._config import resolve_device
from boofcv_tpu_torch.examples import parse_device
from boofcv_tpu_torch.ip import color


def _scene():
    rng = np.random.default_rng(0)
    return rng.uniform(0, 255, (40, 50, 3)).astype(np.float32)


def main(argv=None) -> int:
    dev = resolve_device(parse_device(argv))
    rgb_np = _scene()
    rgb = torch.as_tensor(rgb_np, device=dev)
    h = lambda x: x.cpu().numpy()
    e_hsv = np.abs(h(color.hsv_to_rgb(color.rgb_to_hsv(rgb)))
                   - rgb_np).max()
    e_yuv = np.abs(h(color.yuv_to_rgb(color.rgb_to_yuv(rgb)))
                   - rgb_np).max()
    e_lab = np.abs(h(color.lab_to_rgb(color.rgb_to_lab(rgb / 255.0)))
                   * 255.0 - rgb_np).max()
    gray = h(color.rgb_to_gray(rgb))
    # pure-colour hues: red 0, green 2pi/3, blue 4pi/3
    pure = torch.tensor([[[255.0, 0, 0], [0, 255.0, 0], [0, 0, 255.0]]],
                        device=dev)
    hue = h(color.rgb_to_hsv(pure))[0, :, 0]
    print(f"device: {dev}")
    print(f"round-trip max err: HSV {e_hsv:.3f}, YUV {e_yuv:.3f}, "
          f"LAB {e_lab:.3f}")
    print(f"pure hues: {np.degrees(hue).round(1)} deg (expect 0/120/240); "
          f"gray range {gray.min():.0f}..{gray.max():.0f}")
    ok = (e_hsv < 0.1 and e_yuv < 1.0 and e_lab < 1.0
          and np.allclose(np.degrees(hue), [0, 120, 240], atol=1.0))
    print("OK" if ok else "FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
