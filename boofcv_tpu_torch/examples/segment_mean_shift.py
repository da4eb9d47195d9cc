"""Mean-shift segmentation: edge-preserving filter + region merge (port of
``boofcv_tpu/examples/segment_mean_shift.py``).

Reference analog: examples/segmentation/ExampleSegmentColor.java with
SegmentMeanShift — smooth within regions, preserve edges, merge into labeled
segments.  Oracle: three flat regions with noise segment into three dominant
labels with the noise smoothed away inside each. The JAX example's ``--tpu``
flag and ``setup_backend`` have no counterpart: ``--device`` picks the
device.

    python -m boofcv_tpu_torch.examples.segment_mean_shift [--device cpu|cuda]
"""

from __future__ import annotations

import numpy as np

from boofcv_tpu_torch._config import resolve_device
from boofcv_tpu_torch.examples import parse_device
from boofcv_tpu_torch.feature import segmentation


def _scene():
    """A disk and a rectangle of two levels on a third, sigma-6 noise."""
    rng = np.random.default_rng(2)
    img = np.zeros((80, 110), np.float32)
    yy, xx = np.mgrid[0:80, 0:110]
    img[:] = 60.0
    img[(yy - 40) ** 2 + (xx - 30) ** 2 < 20 ** 2] = 150.0
    img[(np.abs(yy - 40) < 24) & (np.abs(xx - 82) < 17)] = 220.0
    img += rng.normal(0, 6, img.shape)
    return img


def main(argv=None) -> int:
    dev = resolve_device(parse_device(argv))
    img = _scene()
    labels, filtered = segmentation.segment_mean_shift(
        img, spatial_radius=3, range_sigma=18.0, merge_threshold=10.0,
        device=dev)
    filtered = filtered.cpu().numpy()
    print(f"device: {dev}")
    # noise inside regions must shrink a lot after filtering
    yy, xx = np.mgrid[0:80, 0:110]
    inner = (yy - 40) ** 2 + (xx - 30) ** 2 < 15 ** 2
    noise_in = float(img[inner].std())
    noise_out = float(filtered[inner].std())
    sizes = np.bincount(labels.ravel())
    big = np.sort(sizes)[::-1][:3]
    print(f"in-region noise {noise_in:.1f} -> {noise_out:.1f}; "
          f"segments {len(sizes)}, top-3 cover "
          f"{big.sum() / labels.size:.0%}")
    ok = noise_out < 0.4 * noise_in and big.sum() > 0.9 * labels.size
    print("OK" if ok else "FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
