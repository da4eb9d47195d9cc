"""Find a template inside an image (port of
``boofcv_tpu/examples/template_matching.py``).

Reference analog: examples/features/ExampleTemplateMatching.java — SSD,
SAD and NCC template search, the peak is the object's location.

    python -m boofcv_tpu_torch.examples.template_matching [--device cpu|cuda]
"""

from __future__ import annotations

import numpy as np
import torch

from boofcv_tpu_torch._config import resolve_device
from boofcv_tpu_torch.examples import parse_device
from boofcv_tpu_torch.feature import template
from boofcv_tpu_torch.io import simulate


def main(argv=None) -> int:
    dev = resolve_device(parse_device(argv))
    rng = np.random.default_rng(18)
    scene = simulate.noise_texture(rng, size=200, octaves=5)[:150, :200]
    ty, tx = 58, 117
    tmpl = torch.as_tensor(scene[ty:ty + 15, tx:tx + 21].copy(), device=dev)
    noisy = torch.as_tensor(
        (scene + rng.normal(0, 2, scene.shape)).astype(np.float32),
        device=dev)
    print(f"device: {dev}")
    ok = True
    for name, fn in [("ssd", template.match_ssd), ("sad", template.match_sad),
                     ("ncc", template.match_ncc)]:
        # every score map is higher-is-better (SSD and SAD are negated)
        det = template.find_matches(fn(noisy, tmpl), max_matches=1)
        py, px = int(det.ys[0]), int(det.xs[0])
        err = max(abs(py - ty), abs(px - tx))
        print(f"{name}: peak at ({py}, {px}), true ({ty}, {tx}), err {err}")
        ok &= err <= 1
    print("OK" if ok else "FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
