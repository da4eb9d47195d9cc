"""Batch-downsize a directory of images (port of
``boofcv_tpu/cli/batch_downsize.py``).

Reference analog: applications/.../BatchDownsizeImage.java:43 — walk the
input directory, shrink every image so it fits inside --max-size (or by
an explicit --scale), and write the results.  The reference uses
average down-sampling (AverageDownSampleOps) to avoid aliasing; here an
integer shrink factor takes the same box-average path (numpy, on the host)
and fractional factors go through bilinear warp resampling
(ip.distort.scale, on the device).

Usage:
  python -m boofcv_tpu_torch.cli.batch_downsize --input DIR --output DIR \\
      [--max-size 640 | --scale 2] [--device cpu|cuda]
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from boofcv_tpu_torch._config import resolve_device


def downsize(gray, factor: float, device=None):
    """Shrink a [H, W] float image by ``factor`` (>= 1); numpy out.  A
    fractional factor resamples on ``device`` (None: the card)."""
    from boofcv_tpu_torch.ip import distort

    h, w = gray.shape
    if abs(factor - round(factor)) < 1e-9 and factor >= 1:
        f = int(round(factor))
        if f == 1:
            return np.asarray(gray)
        hh, ww = h // f * f, w // f * f
        return np.asarray(gray[:hh, :ww].reshape(
            hh // f, f, ww // f, f).mean((1, 3)))
    out_shape = (max(1, int(round(h / factor))),
                 max(1, int(round(w / factor))))
    img = torch.as_tensor(np.asarray(gray), dtype=torch.float32,
                          device=resolve_device(device))
    return distort.scale(img, out_shape).cpu().numpy()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--input", required=True)
    ap.add_argument("--output", required=True)
    g = ap.add_mutually_exclusive_group(required=True)
    g.add_argument("--max-size", type=int,
                   help="largest output side length, aspect preserved")
    g.add_argument("--scale", type=float,
                   help="shrink factor >= 1 (2 halves each side)")
    ap.add_argument("--device", choices=("cpu", "cuda"), default=None,
                    help="default: the card (raises without one)")
    args = ap.parse_args(argv)
    if args.scale is not None and args.scale < 1.0:
        ap.error("--scale is a shrink factor >= 1 (2 halves each side); "
                 f"got {args.scale}")
    if args.max_size is not None and args.max_size < 1:
        ap.error(f"--max-size must be >= 1; got {args.max_size}")
    dev = resolve_device(args.device)

    from boofcv_tpu_torch.io import image_io

    os.makedirs(args.output, exist_ok=True)
    files = sorted(f for f in os.listdir(args.input)
                   if os.path.splitext(f)[1].lower() in
                   (".png", ".pgm", ".ppm"))
    n = 0
    for f in files:
        img = image_io.load(os.path.join(args.input, f))
        gray = image_io.to_gray(img).astype(np.float32)
        if args.scale is not None:
            factor = args.scale
        else:
            factor = max(1.0, max(gray.shape) / float(args.max_size))
        out = downsize(gray, factor, device=dev)
        image_io.save(os.path.join(args.output, f),
                      np.clip(out, 0, 255).astype(np.uint8))
        n += 1
    print(f"downsized {n}/{len(files)} images -> {args.output}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
