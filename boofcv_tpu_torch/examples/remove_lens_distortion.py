"""Remove lens distortion and convert a fisheye view to a pinhole view (port of
``boofcv_tpu/examples/remove_lens_distortion.py``).

Reference analogs: examples/calibration/ExampleRemoveLensDistortion.java and
ExampleFisheyeToPinhole.java — build the undistortion transform from the
calibrated camera model and warp the image through it. The JAX example's
``--tpu`` flag and ``setup_backend`` have no counterpart: ``--device`` picks
the device.

    python -m boofcv_tpu_torch.examples.remove_lens_distortion [--device cpu|cuda]
"""

from __future__ import annotations

import numpy as np
import torch

from boofcv_tpu_torch._config import resolve_device
from boofcv_tpu_torch.examples import parse_device
from boofcv_tpu_torch.geo import cameras
from boofcv_tpu_torch.io import simulate
from boofcv_tpu_torch.ip import distort

H, W = 160, 200


def _scene():
    """The ideal (pinhole) image: a crop of the JAX example's texture."""
    rng = np.random.default_rng(21)
    tex = simulate.noise_texture(rng, size=340, octaves=5)
    return tex[:H, :W].astype(np.float32)


def main(argv=None) -> int:
    dev = resolve_device(parse_device(argv))
    ideal = _scene()
    # --- Brown radial distortion round trip ------------------------------
    cam = cameras.CameraPinholeBrown(fx=180.0, fy=180.0, cx=W / 2, cy=H / 2,
                                     width=W, height=H, radial=(-0.25, 0.05))
    # synthesize a DISTORTED capture: for each distorted pixel, sample the
    # ideal (pinhole) image at the corresponding undistorted position
    ys, xs = torch.meshgrid(
        torch.arange(H, dtype=torch.float64, device=dev),
        torch.arange(W, dtype=torch.float64, device=dev), indexing="ij")
    nx, ny = cameras.pixel_to_norm_undistorted(cam, xs, ys)
    ux = nx * cam.fx + cam.cx
    uy = ny * cam.fy + cam.cy
    captured = distort.warp(torch.as_tensor(ideal, device=dev),
                            uy.to(torch.float32), ux.to(torch.float32))
    # undistortion warp: for each output (pinhole) pixel, find where it
    # lands in the distorted capture
    nx0 = (xs - cam.cx) / cam.fx
    ny0 = (ys - cam.cy) / cam.fy
    dx, dy = cameras.distort_norm(cam, nx0, ny0)
    sx = dx * cam.fx + cam.cx
    sy = dy * cam.fy + cam.cy
    undistorted = distort.warp(captured, sy.to(torch.float32),
                               sx.to(torch.float32)).cpu().numpy()
    print(f"device: {dev}")
    c = np.s_[25:-25, 25:-25]
    err = np.abs(undistorted[c] - ideal[c])
    print(f"brown undistort: median |err| {np.median(err):.1f} "
          f"(image range {ideal.min():.0f}..{ideal.max():.0f})")
    ok = np.median(err) < 6.0
    # --- fisheye (universal omni) -> pinhole ------------------------------
    fish = cameras.CameraUniversalOmni(fx=120.0, fy=120.0, cx=W / 2,
                                       cy=H / 2, width=W, height=H,
                                       mirror_offset=1.0)
    pin = cameras.CameraPinhole(fx=90.0, fy=90.0, cx=W / 2, cy=H / 2,
                                width=W, height=H)
    # output pinhole pixel -> 3D ray -> fisheye pixel
    rx = (xs - pin.cx) / pin.fx
    ry = (ys - pin.cy) / pin.fy
    rays = torch.stack([rx, ry, torch.ones_like(rx)], -1)
    fx_px, fy_px = cameras.omni_project(fish, rays)
    pinhole_view = distort.warp(captured, fy_px.to(torch.float32),
                                fx_px.to(torch.float32)).cpu().numpy()
    # sanity: the centre of the fisheye frame maps near the centre of the
    # pinhole output, and the warp produced in-range intensities
    print(f"fisheye->pinhole: output range "
          f"{pinhole_view.min():.0f}..{pinhole_view.max():.0f}")
    ok &= np.isfinite(pinhole_view).all() \
        and pinhole_view.max() > pinhole_view.min() + 50
    print("OK" if ok else "FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
