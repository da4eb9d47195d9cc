"""Readings for the limits of ``correct``: the program's check numbers on
many seeds, and the control's on a few, in one process.

    python perfbench/control.py --workload <cell> --seconds <s> \
        --seeds 1,2,3 --control-seeds 4,5,6 [--control tf32,bf16_images] \
        [--fault-seeds 7,8,9 --fault retire_all]

The control is the program with the nearest precision below the stated
one switched on, or the reference computed in it standing in the
program's place (``controls/<name>.py``, several joined by commas): the
configuration states float32 with TF32 off for matrix products, whence
``tf32`` and ``ref_pose_tf32``, and float32 for the image path, whence
``bf16_images``.  A fault (``faults/<name>.py``) is read the same way.
Each run is a whole run of the cell at its own size (set-up, a short
window, the check); one JSON line a run goes to standard output.  Not
part of the benchmark's runs.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, HERE)
sys.path.insert(0, ROOT)

from harness import cell, spec  # noqa: E402


DEFAULT = "tf32,ref_pose_tf32,bf16_images"


def _seeds(text: str) -> list:
    return [int(s) for s in text.split(",") if s]


def readings(bench, workload, seconds, seeds, control, name, device=None,
             kind="controls"):
    """One dict a seed: the run's check numbers and its ``correct``;
    ``control`` True applies the modules ``name`` of ``kind`` to the port
    handle of the cell's kind."""
    port = bench.resolve(workload)["kind"].port()
    out = []
    for seed in seeds:
        undo = ([bench.module(kind, c).apply(port)
                 for c in name.split(",")] if control else [])
        try:
            res = cell.run(bench, workload, seed, seconds, False,
                           time.perf_counter(), device=device)
        finally:
            for u in reversed(undo):
                u()
        out.append({"workload": workload, "seed": seed,
                    "control": name if control else None, "kind": kind,
                    "correct": res["correct"],
                    "numbers": {k: c["value"]
                                for k, c in res["checks"].items()},
                    "metrics": {k: m["value"]
                                for k, m in res["metrics"].items()}})
        print(json.dumps(out[-1]), flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--seeds", type=_seeds, default=[])
    ap.add_argument("--control-seeds", type=_seeds, default=[])
    ap.add_argument("--control", default=DEFAULT)
    ap.add_argument("--fault-seeds", type=_seeds, default=[])
    ap.add_argument("--fault", default="retire_all")
    args = ap.parse_args(argv)
    bench = spec.Benchmark(ROOT)
    readings(bench, args.workload, args.seconds, args.seeds, False,
             args.control)
    readings(bench, args.workload, args.seconds, args.control_seeds, True,
             args.control)
    readings(bench, args.workload, args.seconds, args.fault_seeds, True,
             args.fault, kind="faults")
    return 0


if __name__ == "__main__":
    sys.exit(main())
