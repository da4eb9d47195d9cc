"""360 imagery: render cameras onto an equirectangular canvas and pull
pinhole views back out (port of
``boofcv_tpu/examples/equirectangular_views.py``).

Reference analogs: examples/imageprocessing/ExampleFisheyeToEquirectangular
.java and ExampleEquirectangularToPinhole.java — a pinhole and a fisheye
(universal-omni) view go onto 360 canvases and a rotated pinhole view is
sampled back; every step is a precomputed warp grid + one batched gather.

    python -m boofcv_tpu_torch.examples.equirectangular_views [--device cpu|cuda]
"""

from __future__ import annotations

import numpy as np
import torch

from boofcv_tpu_torch._config import resolve_device
from boofcv_tpu_torch.examples import parse_device
from boofcv_tpu_torch.geo import cameras, spherical


def main(argv=None) -> int:
    dev = resolve_device(parse_device(argv))

    # a pinhole "ground truth" scene viewed straight ahead
    pin = cameras.CameraPinhole(fx=140, fy=140, cx=79.5, cy=59.5,
                                width=160, height=120)
    yy, xx = np.mgrid[0:120, 0:160].astype(np.float32)
    view = torch.from_numpy(60 + 45 * np.sin(xx / 13.0)
                            * np.cos(yy / 9.0)).to(dev)

    a = 0.6
    R = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                  [-np.sin(a), 0, np.cos(a)]])

    # camera -> 360 canvas, then the rotated view back out of it
    canvas = spherical.camera_to_equi(view, pin, R, (256, 512))
    cov = float((canvas != 0).float().mean())
    back = spherical.equi_to_pinhole(canvas, pin, R, (120, 160))
    err = float(np.median(np.abs(back.cpu().numpy() - view.cpu().numpy())
                          [20:-20, 20:-20]))
    print(f"device: {dev}")
    print(f"camera->equi coverage: {cov:.3f}, "
          f"equi->pinhole round-trip median err: {err:.2f}")

    # fisheye hemisphere onto the canvas
    omni = cameras.CameraUniversalOmni(
        fx=130, fy=130, cx=149.5, cy=149.5, width=300, height=300,
        mirror_offset=1.0)
    fe = 100 + 50 * np.sin(xx[:120, :160] / 17.0)
    fe = torch.from_numpy(np.tile(fe, (3, 2))[:300, :300].copy()).to(dev)
    canvas_fe = spherical.camera_to_equi(fe, omni, np.eye(3), (128, 256))
    cov_fe = float((canvas_fe != 0).float().mean())
    print(f"fisheye->equi coverage: {cov_fe:.3f} (hemisphere+ FOV)")

    ok = cov > 0.03 and err < 2.5 and cov_fe > 0.4
    print("OK" if ok else "FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
