"""Scan a directory of images for QR codes (port of
``boofcv_tpu/cli/batch_scan_qr.py``).

Reference analog: applications/.../BatchScanQrCodes.java.

Usage: python -m boofcv_tpu_torch.cli.batch_scan_qr --images DIR \\
    [--device cpu|cuda]
"""

from __future__ import annotations

import argparse
import os
import sys

from boofcv_tpu_torch._config import resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--images", required=True)
    ap.add_argument("--device", choices=("cpu", "cuda"), default=None,
                    help="default: the card (raises without one)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    from boofcv_tpu_torch.io import image_io
    from boofcv_tpu_torch.recognition.qr import detector

    files = sorted(f for f in os.listdir(args.images)
                   if os.path.splitext(f)[1].lower() in
                   (".png", ".pgm", ".ppm"))
    found = 0
    for f in files:
        img = image_io.to_gray(image_io.load(os.path.join(args.images, f)))
        out, info = detector.detect_and_decode(img, device=dev)
        if out is None:
            print(f"{f}: no QR ({info.get('error')})")
        else:
            found += 1
            print(f"{f}: v{info['version']}-{info['level']} "
                  f"\"{out.decode('utf8', 'replace')}\"")
    print(f"decoded {found}/{len(files)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
