"""Render square binary fiducial markers to image files (port of
``boofcv_tpu/cli/create_fiducial.py``).

Reference analog: applications/.../CreateFiducialSquareBinary.java (PDF
generation; here raster PNG/PGM at a chosen pixel size).

Usage:
    python -m boofcv_tpu_torch.cli.create_fiducial --ids 7 42 --size 256 \\
        --output-dir markers/ [--device cpu|cuda]

The markers are drawn with numpy on the host; ``--device`` is checked as in
every command (the default is the card, and without one it raises).
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from boofcv_tpu_torch._config import resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--ids", type=int, nargs="+", required=True)
    ap.add_argument("--size", type=int, default=256,
                    help="marker side length in pixels")
    ap.add_argument("--white-border", type=int, default=16,
                    help="quiet-zone width in pixels")
    ap.add_argument("--output-dir", default=".")
    ap.add_argument("--device", choices=("cpu", "cuda"), default=None,
                    help="default: the card (raises without one)")
    args = ap.parse_args(argv)
    resolve_device(args.device)

    from boofcv_tpu_torch.io import image_io
    from boofcv_tpu_torch.recognition import fiducial_square as fs

    os.makedirs(args.output_dir, exist_ok=True)
    for mid in args.ids:
        if not 0 <= mid <= fs.max_marker_id():
            print(f"id {mid} out of range (max {fs.max_marker_id()})")
            return 1
        # encode_marker returns a rendered marker (incl. quiet zone);
        # nearest-resample to the requested output size
        src = fs.encode_marker(mid).astype(np.uint8)
        sh = src.shape[0]
        size = args.size + 2 * args.white_border
        yi = (np.arange(size) * sh // size).clip(0, sh - 1)
        out = src[yi[:, None], yi[None, :]]
        path = os.path.join(args.output_dir, f"fiducial_{mid:04d}.png")
        image_io.save(path, out)
        print(f"wrote {path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
