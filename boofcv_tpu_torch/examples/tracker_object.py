"""Track an object through a video with TLD and the circulant tracker
(port of ``boofcv_tpu/examples/tracker_object.py``).

Reference analog: examples/tracking/ExampleTrackerObjectQuad.java — the
unified object-tracker interface.  A textured object translates across a
noisy background; each tracker's final box centre must lie within 5 px of
the known trajectory (the JAX example's oracle).

    python -m boofcv_tpu_torch.examples.tracker_object [--device cpu|cuda]
"""

from __future__ import annotations

import numpy as np
import torch

from boofcv_tpu_torch._config import resolve_device
from boofcv_tpu_torch.examples import parse_device
from boofcv_tpu_torch.feature import trackers
from boofcv_tpu_torch.recognition import tld


def _frame(rng_seed, cy, cx, h=120, w=160):
    rng = np.random.default_rng(rng_seed)
    yy, xx = np.mgrid[0:h, 0:w]
    bg = rng.normal(100, 3, (h, w))
    u = yy - cy
    v = xx - cx
    obj = (np.abs(u) < 12) & (np.abs(v) < 12)
    tex = 50 * np.sign(np.sin(u * 0.9 + v * 0.31) + 0.4 * np.cos(v * 0.53)) \
        + 2.0 * u
    return (bg + np.where(obj, 70 + tex, 0)).astype(np.float32)


def main(argv=None) -> int:
    dev = resolve_device(parse_device(argv))
    path = [(40, 50), (43, 56), (46, 62), (49, 68), (52, 74)]
    frame = lambda cy, cx: torch.as_tensor(_frame(0, cy, cx), device=dev)
    ok_all = True

    t = tld.make_tracker(device=dev)
    t.initialize(frame(*path[0]), path[0][0], path[0][1], 24, 24)
    err = 0.0
    for cy, cx in path[1:]:
        ok, box = t.process(frame(cy, cx))
        err = max(abs(box[0] - cy), abs(box[1] - cx)) if ok else 99.0
    print(f"device: {dev}")
    print(f"tld      : final center error {err:.1f} px")
    ok_all &= err < 5

    st = trackers.circulant_init(frame(*path[0]), path[0][0], path[0][1],
                                 size=48)
    for cy, cx in path[1:]:
        st = trackers.circulant_track(st, frame(cy, cx))
    err = max(abs(float(st.cy) - path[-1][0]),
              abs(float(st.cx) - path[-1][1]))
    print(f"circulant: final center error {err:.1f} px")
    ok_all &= err < 5

    print("OK" if ok_all else "FAILED")
    return 0 if ok_all else 1


if __name__ == "__main__":
    raise SystemExit(main())
