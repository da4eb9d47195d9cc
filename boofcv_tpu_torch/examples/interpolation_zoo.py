"""Pixel interpolation methods compared on upsampling (port of
``boofcv_tpu/examples/interpolation_zoo.py``).

Reference analog: examples/imageprocessing/ExampleInterpolation.java —
nearest / bilinear / bicubic sampling of the same image.  Oracle: on a
smooth analytic image, bicubic beats bilinear beats nearest in
reconstruction error. The JAX example's ``--tpu`` flag and ``setup_backend``
have no counterpart: ``--device`` picks the device.

    python -m boofcv_tpu_torch.examples.interpolation_zoo [--device cpu|cuda]
"""

from __future__ import annotations

import numpy as np
import torch

from boofcv_tpu_torch._config import resolve_device
from boofcv_tpu_torch.examples import parse_device
from boofcv_tpu_torch.ip import interpolate


def _f(y, x):
    return 100 + 60 * np.sin(x / 6.5) * np.cos(y / 5.0)


def _scene():
    """(image [48, 64] float32, query ys, query xs): a smooth function
    sampled on the grid, and a 4x denser off-grid lattice."""
    ys, xs = np.mgrid[0:48, 0:64].astype(np.float64)
    qy, qx = np.mgrid[4:43:0.25, 4:59:0.25]
    return _f(ys, xs).astype(np.float32), qy, qx


def main(argv=None) -> int:
    dev = resolve_device(parse_device(argv))
    img, qy, qx = _scene()
    truth = _f(qy, qx)
    on = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)
    print(f"device: {dev}")
    errs = {}
    for name, fn in (("nearest", interpolate.nearest),
                     ("bilinear", interpolate.bilinear),
                     ("bicubic", interpolate.bicubic)):
        v = fn(on(img), on(qy.ravel()), on(qx.ravel())).cpu().numpy()
        errs[name] = float(np.abs(v.reshape(truth.shape) - truth).mean())
        print(f"{name:9s} mean |err| {errs[name]:.4f}")
    ok = errs["bicubic"] < errs["bilinear"] < errs["nearest"] \
        and errs["bicubic"] < 0.2
    print("OK" if ok else "FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
