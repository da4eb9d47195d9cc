"""Detect square binary fiducials in a directory of images, with optional
pose when a calibration is supplied (port of
``boofcv_tpu/cli/fiducial_detection.py``).

Reference analog: applications/.../FiducialDetection.java.

Usage:
  python -m boofcv_tpu_torch.cli.fiducial_detection --images DIR \\
      [--calib calib.yaml --size 0.1] [--device cpu|cuda]
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from boofcv_tpu_torch._config import resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--images", required=True)
    ap.add_argument("--calib", help="pinhole-Brown YAML (enables pose)")
    ap.add_argument("--size", type=float, default=0.1,
                    help="marker side length in world units")
    ap.add_argument("--min-area", type=float, default=400.0)
    ap.add_argument("--device", choices=("cpu", "cuda"), default=None,
                    help="default: the card (raises without one)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    from boofcv_tpu_torch.io import calibration_io, image_io
    from boofcv_tpu_torch.recognition import fiducial_square

    K = None
    if args.calib:
        cam = calibration_io.load_pinhole_brown(args.calib)
        K = np.asarray(cam.K)

    files = sorted(f for f in os.listdir(args.images)
                   if os.path.splitext(f)[1].lower() in
                   (".png", ".pgm", ".ppm"))
    total = 0
    for f in files:
        gray = image_io.to_gray(image_io.load(os.path.join(args.images, f)))
        dets = fiducial_square.detect(gray, min_area=args.min_area,
                                      device=dev)
        for d in dets:
            total += 1
            c = np.asarray(d["corners"]).mean(axis=0)
            line = (f"{f}: id={d['id']} center=({c[0]:.1f}, {c[1]:.1f})"
                    f" rot={d['rotation']}")
            if K is not None:
                R, t = fiducial_square.estimate_pose(
                    d["corners"], args.size, K, device=dev)
                dist = float(np.linalg.norm(t))
                line += f" range={dist:.3f}"
            print(line)
    print(f"found {total} fiducials in {len(files)} images")
    return 0


if __name__ == "__main__":
    sys.exit(main())
