"""Discrete and float-scale image pyramids (port of
``boofcv_tpu/examples/image_pyramids.py``).

Reference analog: examples/imageprocessing/ExamplePyramidDiscrete.java +
ExamplePyramidFloat.java — blur-and-decimate octave pyramids and Gaussian
scale space.  Oracle: level shapes halve per octave; energy is preserved at
low frequencies and fine detail is progressively removed. The JAX example's
``--tpu`` flag and ``setup_backend`` have no counterpart: ``--device`` picks
the device.

    python -m boofcv_tpu_torch.examples.image_pyramids [--device cpu|cuda]
"""

from __future__ import annotations

import numpy as np
import torch

from boofcv_tpu_torch._config import resolve_device
from boofcv_tpu_torch.core.pyramid import PyramidConfig
from boofcv_tpu_torch.examples import parse_device
from boofcv_tpu_torch.ip import pyramid_ops


def _coarse(y, x):
    return 120 + 50 * np.sin(x / 19.0)


def _scene():
    """A coarse sinusoid, a fine carrier and unit noise, 128x160."""
    rng = np.random.default_rng(2)
    yy, xx = np.mgrid[0:128, 0:160].astype(np.float32)
    fine = 25 * np.sin(xx * 1.9) * np.cos(yy * 2.1)
    return (_coarse(yy, xx) + fine
            + rng.normal(0, 1, (128, 160)).astype(np.float32))


def main(argv=None) -> int:
    dev = resolve_device(parse_device(argv))
    img = torch.as_tensor(_scene(), device=dev)
    cfg = PyramidConfig(scales=(1, 2, 4, 8))
    pyr = [p.cpu().numpy() for p in pyramid_ops.pyramid_discrete(img, cfg)]
    print(f"device: {dev}")
    shapes = [tuple(p.shape) for p in pyr]
    print(f"discrete pyramid shapes: {shapes}")
    # residual vs the analytic COARSE image sampled at each level's
    # grid: the fine carrier must vanish up the pyramid while the
    # coarse sinusoid survives
    resid = []
    for k, p in enumerate(pyr):
        s = cfg.scales[k]
        hy, hx = np.mgrid[0:p.shape[0], 0:p.shape[1]].astype(np.float32)
        resid.append(float(np.std(p - _coarse(hy * s, hx * s))))
    print(f"per-level fine residual std: {[round(v, 2) for v in resid]}")
    gss = pyramid_ops.gaussian_scale_space(img, sigmas=(1.0, 2.0, 4.0))
    coarse_ok = float(gss[-1].std()) > 20       # the coarse wave survives
    ok = (shapes == [(128, 160), (64, 80), (32, 40), (16, 20)]
          and resid[0] > 3 * resid[2] and resid[2] < 7 and coarse_ok)
    print("OK" if ok else "FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
