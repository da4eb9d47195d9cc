"""Dense HOG features for whole-image description (port of
``boofcv_tpu/examples/dense_image_features.py``).

Reference analog: examples/features/ExampleDenseImageFeatures.java — a
regular grid of HOG block descriptors.  Oracle: descriptors from a
vertically-striped region are dominated by vertical-edge orientation bins; a
texture-matched query region ranks its own patch first. The JAX example's
``--tpu`` flag and ``setup_backend`` have no counterpart: ``--device`` picks
the device.

    python -m boofcv_tpu_torch.examples.dense_image_features [--device cpu|cuda]
"""

from __future__ import annotations

import numpy as np

from boofcv_tpu_torch._config import resolve_device
from boofcv_tpu_torch.examples import parse_device
from boofcv_tpu_torch.feature import dense


def _scene():
    """Vertical stripes on the left, horizontal on the top right, flat on
    the bottom right, sigma-2 noise; 96x128."""
    rng = np.random.default_rng(0)
    img = np.zeros((96, 128), np.float32)
    xx = np.arange(128)[None, :]
    yy = np.arange(96)[:, None]
    img[:, :64] = 120 + 80 * np.sign(np.sin(xx[:, :64] * 1.2))  # vertical
    img[:48, 64:] = 120 + 80 * np.sign(np.sin(yy[:48] * 1.2))   # horizontal
    img[48:, 64:] = 120.0                                       # flat
    img += rng.normal(0, 2.0, img.shape)
    return img


def main(argv=None) -> int:
    dev = resolve_device(parse_device(argv))
    desc = dense.hog(_scene(), cell_size=8, block_cells=2, num_bins=9,
                     device=dev).cpu().numpy()
    print(f"device: {dev}")
    by, bx, d = desc.shape
    print(f"HOG grid: {by}x{bx} blocks x {d}-D")
    # vertical stripes -> gradient along x -> orientation bin near 0
    v_block = desc[5, 2].reshape(4, 9).mean(0)
    h_block = desc[2, 10].reshape(4, 9).mean(0)
    v_peak = int(np.argmax(v_block))
    h_peak = int(np.argmax(h_block))
    print(f"vertical-stripe peak bin {v_peak}, horizontal-stripe "
          f"peak bin {h_peak} (9 bins over 180 deg)")
    # the two textures must peak in clearly different orientation bins
    sep = min(abs(v_peak - h_peak), 9 - abs(v_peak - h_peak))
    flat_energy = np.linalg.norm(desc[10, 12])
    ok = sep >= 3 and np.linalg.norm(v_block) > 0.1 \
        and flat_energy < np.linalg.norm(desc[5, 2])
    print("OK" if ok else "FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
