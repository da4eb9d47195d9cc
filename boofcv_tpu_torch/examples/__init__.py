"""Runnable examples of the port.  Each module is a self-contained demo: it
synthesizes input with a known ground truth, runs one library pipeline end
to end, prints a checkable result, and exits 0 on success.  Run as::

    python -m boofcv_tpu_torch.examples.<name> [--device cpu|cuda]

The default device is the card; without one the demo raises.
"""

from __future__ import annotations

import argparse


def parse_device(argv=None):
    """``--device cpu|cuda`` from ``argv`` (None: the command line); None
    when it is not given, which the entry points read as the card."""
    ap = argparse.ArgumentParser(add_help=False)
    ap.add_argument("--device", choices=("cpu", "cuda"), default=None)
    return ap.parse_known_args(argv)[0].device
