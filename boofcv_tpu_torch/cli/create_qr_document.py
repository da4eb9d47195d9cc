"""Create a printable image with one or more QR codes (port of
``boofcv_tpu/cli/create_qr_document.py``).

Reference analog: applications/.../CreateQrCodeDocument.java (PDF out in
the reference; PNG/PNM here — no PDF dependency in the image).

Usage:
  python -m boofcv_tpu_torch.cli.create_qr_document --message "HELLO" \\
      [--message "SECOND"] [--level M] [--module-px 6] --output doc.png \\
      [--device cpu|cuda]

The document is drawn with numpy on the host; ``--device`` is checked as in
every command (the default is the card, and without one it raises).
"""

from __future__ import annotations

import argparse
import sys

from boofcv_tpu_torch._config import resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--message", action="append", required=True,
                    help="repeatable: one QR per message")
    ap.add_argument("--level", default="M", choices="LMQH")
    ap.add_argument("--module-px", type=int, default=6)
    ap.add_argument("--margin-px", type=int, default=40)
    ap.add_argument("--output", required=True)
    ap.add_argument("--device", choices=("cpu", "cuda"), default=None,
                    help="default: the card (raises without one)")
    args = ap.parse_args(argv)
    resolve_device(args.device)

    import numpy as np
    from boofcv_tpu_torch.io import image_io
    from boofcv_tpu_torch.recognition.qr import code as qr
    from boofcv_tpu_torch.recognition.qr import detector

    tiles = [detector.render(qr.encode(m, level=args.level),
                             module_px=args.module_px)
             for m in args.message]
    m = args.margin_px
    hmax = max(t.shape[0] for t in tiles)
    wtot = sum(t.shape[1] for t in tiles) + m * (len(tiles) + 1)
    doc = np.full((hmax + 2 * m, wtot), 255.0, np.float32)
    x = m
    for t in tiles:
        doc[m:m + t.shape[0], x:x + t.shape[1]] = t
        x += t.shape[1] + m
    image_io.save(args.output, doc.astype(np.uint8))
    print(f"wrote {len(tiles)} QR code(s) ({args.level}) to {args.output} "
          f"({doc.shape[1]}x{doc.shape[0]})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
