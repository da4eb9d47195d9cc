"""Calibrate a camera from chessboard images (port of
``boofcv_tpu/cli/camera_calibration.py``).

Reference analog: applications/.../CameraCalibration.java.

Usage:
    python -m boofcv_tpu_torch.cli.camera_calibration \\
        --images DIR --rows 4 --cols 5 --square 0.03 --output camera.yaml \\
        [--device cpu|cuda]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from boofcv_tpu_torch._config import resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--images", required=True, help="directory of images")
    ap.add_argument("--rows", type=int, required=True,
                    help="inner corner rows")
    ap.add_argument("--cols", type=int, required=True,
                    help="inner corner cols")
    ap.add_argument("--square", type=float, default=1.0,
                    help="square size (world units)")
    ap.add_argument("--output", default="camera.yaml")
    ap.add_argument("--device", choices=("cpu", "cuda"), default=None,
                    help="default: the card (raises without one)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    from boofcv_tpu_torch.calib import zhang99
    from boofcv_tpu_torch.io import calibration_io as cio
    from boofcv_tpu_torch.io import image_io
    from boofcv_tpu_torch.recognition import chessboard

    images = image_io.load_sequence(args.images)
    if not images:
        print("no images found", file=sys.stderr)
        return 1
    xs, ys = np.meshgrid(np.arange(args.cols) * args.square,
                         np.arange(args.rows) * args.square)
    target = np.stack([xs.ravel(), ys.ravel()], 1)
    target = target - target.mean(0)

    obs = []
    for i, img in enumerate(images):
        gray = image_io.to_gray(img)
        grid = chessboard.detect_chessboard(gray, args.rows, args.cols,
                                            device=dev)
        if grid is None:
            print(f"image {i}: target not found, skipping", file=sys.stderr)
            continue
        obs.append(grid)
    if len(obs) < 3:
        print(f"only {len(obs)} usable views (need >= 3)", file=sys.stderr)
        return 1

    res = zhang99.calibrate_mono_planar(target, np.stack(obs), device=dev)
    h, w = image_io.to_gray(images[0]).shape
    cam = cio.CameraPinholeBrown(
        w, h, float(res.K[0, 0]), float(res.K[1, 1]), float(res.K[0, 1]),
        float(res.K[0, 2]), float(res.K[1, 2]), res.radial)
    cio.save_pinhole_brown(cam, args.output)
    print(f"calibrated from {len(obs)} views; reprojection RMSE "
          f"{res.reprojection_rmse:.4f} px -> {args.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
