"""Run stereo visual odometry over image-sequence directories (port of
``boofcv_tpu/cli/stereo_vo_demo.py``).

Reference analog: examples/sfm/ExampleVisualOdometryStereo.java.

Usage:
    python -m boofcv_tpu_torch.cli.stereo_vo_demo --left DIR --right DIR \\
        [--calib stereo.yaml | --fx 500 --baseline 0.3] \\
        [--output trajectory.txt] [--device cpu|cuda]

Left/right images must already be rectified OR a stereo calib YAML is
given (rectification maps are built from it, and the images are rectified
on the device).  One line a frame in the output: the camera->world
rotation (row-major) and centre, as the JAX command writes them.  A frame
goes to the device in one copy (both images) and comes back in one host
read (the pose with the step's metrics), beside the step's spawn
decision.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from boofcv_tpu_torch._config import resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--left", required=True)
    ap.add_argument("--right", required=True)
    ap.add_argument("--calib", help="stereo calibration yaml")
    ap.add_argument("--fx", type=float, default=500.0)
    ap.add_argument("--baseline", type=float, default=0.3)
    ap.add_argument("--output", default="trajectory.txt")
    ap.add_argument("--device", choices=("cpu", "cuda"), default=None,
                    help="default: the card (raises without one)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    from boofcv_tpu_torch.io import image_io
    from boofcv_tpu_torch.sfm import stereo_vo

    lefts = image_io.load_sequence(args.left)
    rights = image_io.load_sequence(args.right)
    if not lefts or len(lefts) != len(rights):
        print("empty or mismatched sequences", file=sys.stderr)
        return 1
    h, w = image_io.to_gray(lefts[0]).shape

    def upload(lr):
        """A frame's two grey images to the device in one copy."""
        pair = np.stack([image_io.to_gray(lr[0]), image_io.to_gray(lr[1])])
        return torch.as_tensor(pair, dtype=torch.float32, device=dev).unbind()

    if args.calib:
        from boofcv_tpu_torch.geo import rectify
        from boofcv_tpu_torch.io import calibration_io as cio
        from boofcv_tpu_torch.ip.interpolate import bilinear
        sp = cio.load_stereo(args.calib)
        # right-to-left -> left-to-right transform
        R = sp.R_right_to_left.T
        t = -R @ sp.t_right_to_left
        rp = rectify.rectify_calibrated(sp.left.K, sp.right.K, R, t,
                                        device=dev)
        K = rp.rectK.cpu().numpy()
        baseline = rp.baseline
        my1, mx1 = rectify.rectify_maps(rp.rect1, h, w)
        my2, mx2 = rectify.rectify_maps(rp.rect2, h, w)

        def rect(lr):
            l, r = upload(lr)
            return bilinear(l, my1, mx1), bilinear(r, my2, mx2)
    else:
        K = np.array([[args.fx, 0, w / 2], [0, args.fx, h / 2], [0, 0, 1.0]])
        baseline = args.baseline
        rect = upload

    cfg = stereo_vo.StereoVoConfig()
    vo = stereo_vo.StereoVisualOdometry(cfg, K, baseline, h, w, device=dev)
    with open(args.output, "w") as f:
        for i, lr in enumerate(zip(lefts, rights)):
            l, r = rect(lr)
            ok = vo.process(l, r)
            R, c = vo.camera_to_world()
            f.write(" ".join(f"{v:.6f}" for v in
                             np.concatenate([R.ravel(), c])) + "\n")
            print(f"frame {i}: ok={ok} pos=({c[0]:.3f}, {c[1]:.3f}, "
                  f"{c[2]:.3f}) inliers={vo.metrics.get('inliers', '-')}")
    print(f"trajectory -> {args.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
