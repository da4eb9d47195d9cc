"""SURF: Fast-Hessian detection + orientation + 64-D description (port of
``boofcv_tpu/examples/feature_surf.py``).

Reference analog: examples/features/ExampleFeatureSurf.java — detect scale-
space blobs on the integral image, assign orientation, describe. Oracle:
descriptors of the same scene re-match under a rotation+shift, and detected
scales track the rendered blob sizes. The JAX example's ``--tpu`` flag and
``setup_backend`` have no counterpart: ``--device`` picks the device.

    python -m boofcv_tpu_torch.examples.feature_surf [--device cpu|cuda]
"""

from __future__ import annotations

import numpy as np
import torch
from scipy.ndimage import gaussian_filter

from boofcv_tpu_torch._config import resolve_device
from boofcv_tpu_torch.examples import parse_device
from boofcv_tpu_torch.feature import associate, describe, fasthessian
from boofcv_tpu_torch.ip import distort
from boofcv_tpu_torch.ip import integral as ii_ops


def _scene():
    """An asymmetric band-limited texture (radially symmetric blobs would
    leave the SURF orientation undefined and break the rotation check)."""
    rng = np.random.default_rng(4)
    img = gaussian_filter(rng.normal(0, 1, (200, 240)), 3.0)
    return (120 + 60 * img / img.std()).astype(np.float32)


def main(argv=None) -> int:
    dev = resolve_device(parse_device(argv))
    img = torch.as_tensor(_scene(), device=dev)

    def detdesc(image):
        ii = ii_ops.transform(image)
        det = fasthessian.detect_multi_octave(
            ii, max_features_per_octave=40, num_octaves=2)
        ang = describe.orientation_average_haar(ii, det.ys, det.xs,
                                                det.scales)
        return det, describe.surf(ii, det.ys, det.xs, det.scales, ang)

    det1, d1 = detdesc(img)
    # rotate + shift the scene and re-match
    det2, d2 = detdesc(distort.rotate(img, 0.35))
    s = associate.score_euclidean_sq(d1, d2)
    big = 1e12
    s = torch.where(det1.valid[:, None], s, big)
    s = torch.where(det2.valid[None, :], s, big)
    m = associate.associate_mutual(s, max_error=0.25)
    n1 = int(det1.valid.sum())
    nm = int(m.valid.sum())
    print(f"device: {dev}")
    print(f"features: {n1} / {int(det2.valid.sum())}; "
          f"rotation-invariant matches: {nm}")
    ok = n1 >= 5 and nm >= 4
    print("OK" if ok else "FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
