"""Batch-undistort a directory of images given a calibration file (port
of ``boofcv_tpu/cli/batch_remove_distortion.py``).

Reference analog: applications/.../BatchRemoveLensDistortion.java — load
a CameraPinholeBrown calibration YAML, build the undistortion warp ONCE
(float64 on the device, then float32, as the JAX command does: the maps
decide the output pixels), apply it to every image in the input
directory.

Usage:
  python -m boofcv_tpu_torch.cli.batch_remove_distortion \\
      --calib calib.yaml --input DIR --output DIR [--device cpu|cuda]
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

from boofcv_tpu_torch._config import resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--calib", required=True, help="pinhole-Brown YAML")
    ap.add_argument("--input", required=True)
    ap.add_argument("--output", required=True)
    ap.add_argument("--device", choices=("cpu", "cuda"), default=None,
                    help="default: the card (raises without one)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    from boofcv_tpu_torch.geo import cameras
    from boofcv_tpu_torch.io import calibration_io, image_io
    from boofcv_tpu_torch.ip import distort

    cam = calibration_io.load_pinhole_brown(args.calib)
    H, W = cam.height, cam.width
    # one warp grid for the whole batch (ImageDistortCache semantics)
    ys, xs = torch.meshgrid(
        torch.arange(H, dtype=torch.float64, device=dev),
        torch.arange(W, dtype=torch.float64, device=dev), indexing="ij")
    nx0 = (xs - cam.cx) / cam.fx
    ny0 = (ys - cam.cy) / cam.fy
    dx, dy = cameras.distort_norm(cam, nx0, ny0)
    map_x = (dx * cam.fx + cam.cx).to(torch.float32)
    map_y = (dy * cam.fy + cam.cy).to(torch.float32)

    os.makedirs(args.output, exist_ok=True)
    files = sorted(f for f in os.listdir(args.input)
                   if os.path.splitext(f)[1].lower() in
                   (".png", ".pgm", ".ppm"))
    n = 0
    for f in files:
        img = image_io.load(os.path.join(args.input, f))
        gray = image_io.to_gray(img)
        if gray.shape != (H, W):
            print(f"{f}: skipped (size {gray.shape} != calib {(H, W)})")
            continue
        out = distort.warp(torch.as_tensor(gray, dtype=torch.float32,
                                           device=dev),
                           map_y, map_x).cpu().numpy()
        image_io.save(os.path.join(args.output, f),
                      np.clip(out, 0, 255).astype(np.uint8))
        n += 1
    print(f"undistorted {n}/{len(files)} images -> {args.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
