"""Render a calibration target to an image file (port of
``boofcv_tpu/cli/create_calibration_target.py``).

Reference analog: applications/.../CreateCalibrationTarget.java (which
emits printable PDFs; here PNG/PGM rasters at a chosen pixels-per-unit).

Usage:
    python -m boofcv_tpu_torch.cli.create_calibration_target \\
        --type chessboard --rows 5 --cols 6 --square 40 --output target.png \\
        [--device cpu|cuda]
    --type {chessboard, square_grid, circle_regular, circle_hexagonal}

The raster is drawn with numpy on the host; ``--device`` is checked as in
every command (the default is the card, and without one it raises).
"""

from __future__ import annotations

import argparse

import numpy as np

from boofcv_tpu_torch._config import resolve_device


def render_chessboard(rows, cols, square, margin):
    h = rows * square + 2 * margin
    w = cols * square + 2 * margin
    img = np.full((h, w), 255, np.uint8)
    for r in range(rows):
        for c in range(cols):
            if (r + c) % 2 == 0:
                y0 = margin + r * square
                x0 = margin + c * square
                img[y0:y0 + square, x0:x0 + square] = 0
    return img


def render_square_grid(rows, cols, square, space, margin):
    h = rows * square + (rows - 1) * space + 2 * margin
    w = cols * square + (cols - 1) * space + 2 * margin
    img = np.full((h, w), 255, np.uint8)
    for r in range(rows):
        for c in range(cols):
            y0 = margin + r * (square + space)
            x0 = margin + c * (square + space)
            img[y0:y0 + square, x0:x0 + square] = 0
    return img


def render_circle_regular(rows, cols, diameter, pitch, margin):
    h = (rows - 1) * pitch + diameter + 2 * margin
    w = (cols - 1) * pitch + diameter + 2 * margin
    img = np.full((h, w), 255, np.uint8)
    ys, xs = np.mgrid[0:h, 0:w]
    rad = diameter / 2.0
    for r in range(rows):
        for c in range(cols):
            cy = margin + rad + r * pitch
            cx = margin + rad + c * pitch
            img[(ys - cy) ** 2 + (xs - cx) ** 2 <= rad * rad] = 0
    return img


def render_circle_hexagonal(rows, cols, diameter, pitch, margin):
    h = int((rows - 1) * pitch * 0.5 + diameter + 2 * margin)
    w = int((cols - 1) * pitch * 0.5 + diameter + 2 * margin)
    img = np.full((h, w), 255, np.uint8)
    ys, xs = np.mgrid[0:h, 0:w]
    rad = diameter / 2.0
    for r in range(rows):
        for c in range(cols):
            if (r + c) % 2 != 0:
                continue
            cy = margin + rad + r * pitch * 0.5
            cx = margin + rad + c * pitch * 0.5
            img[(ys - cy) ** 2 + (xs - cx) ** 2 <= rad * rad] = 0
    return img


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--type", default="chessboard",
                    choices=["chessboard", "square_grid", "circle_regular",
                             "circle_hexagonal"])
    ap.add_argument("--rows", type=int, required=True)
    ap.add_argument("--cols", type=int, required=True)
    ap.add_argument("--square", type=int, default=40,
                    help="square size / circle diameter in pixels")
    ap.add_argument("--space", type=int, default=None,
                    help="space between squares (square_grid) or center "
                         "pitch (circle grids), pixels")
    ap.add_argument("--margin", type=int, default=40)
    ap.add_argument("--output", default="target.png")
    ap.add_argument("--device", choices=("cpu", "cuda"), default=None,
                    help="default: the card (raises without one)")
    args = ap.parse_args(argv)
    resolve_device(args.device)

    if args.type == "chessboard":
        img = render_chessboard(args.rows, args.cols, args.square,
                                args.margin)
    elif args.type == "square_grid":
        space = args.space if args.space is not None else args.square
        img = render_square_grid(args.rows, args.cols, args.square, space,
                                 args.margin)
    elif args.type == "circle_regular":
        pitch = args.space if args.space is not None else 2 * args.square
        img = render_circle_regular(args.rows, args.cols, args.square,
                                    pitch, args.margin)
    else:
        pitch = args.space if args.space is not None else 2 * args.square
        img = render_circle_hexagonal(args.rows, args.cols, args.square,
                                      pitch, args.margin)

    from boofcv_tpu_torch.io import image_io
    image_io.save(args.output, img)
    print(f"wrote {args.output} ({img.shape[1]}x{img.shape[0]})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
