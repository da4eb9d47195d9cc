"""Track point features through an image sequence with pyramidal KLT
(port of ``boofcv_tpu/examples/point_feature_tracker.py``).

Reference analog: examples/tracking/ExamplePointFeatureTracker.java —
PointTracker detect/track/spawn over a video (KLT through ``klt_track``).
The sequence is a texture sliding by a known offset a frame; the median
track motion is checked.  The JAX example's ``--tpu`` flag and
``setup_backend`` have no counterpart: ``--device`` picks the device.

    python -m boofcv_tpu_torch.examples.point_feature_tracker [--device cpu|cuda]
"""

from __future__ import annotations

import numpy as np
import torch

from boofcv_tpu_torch._config import resolve_device
from boofcv_tpu_torch.examples import parse_device
from boofcv_tpu_torch.feature import point_tracker
from boofcv_tpu_torch.io import simulate

DY, DX = 2, 3


def _scene():
    """Six 180x240 crops of one texture, each (DY, DX) further in."""
    rng = np.random.default_rng(8)
    tex = simulate.noise_texture(rng, size=320, octaves=5)
    return [tex[i * DY:i * DY + 180, i * DX:i * DX + 240].astype(np.float32)
            for i in range(6)]


def main(argv=None) -> int:
    dev = resolve_device(parse_device(argv))
    frames = [torch.as_tensor(f, device=dev) for f in _scene()]
    print(f"device: {dev}")

    tracker = point_tracker.PointTrackerKlt(max_tracks=256,
                                            scales=(1, 2, 4), device=dev)
    tracker.process(frames[0])
    tracker.spawn()
    prev = {t.uid: (t.y, t.x) for t in tracker.active_tracks()}
    total = drifted = 0
    for i, f in enumerate(frames[1:], 1):
        tracker.process(f)
        cur = {t.uid: (t.y, t.x) for t in tracker.active_tracks()}
        m = np.asarray([(cur[u][0] - prev[u][0], cur[u][1] - prev[u][1])
                        for u in cur if u in prev])
        total += len(m)
        # content slides by (-DY, -DX) a frame
        drifted += int(np.sum(np.abs(m + [DY, DX]).max(1) > 0.5))
        print(f"frame {i}: {len(cur)} active tracks, median motion "
              f"({np.median(m[:, 0]):+.2f}, {np.median(m[:, 1]):+.2f}) "
              f"expected ({-DY}, {-DX})")
        prev = cur
    frac = drifted / max(total, 1)
    print(f"drifting track fraction: {frac:.3f}")
    ok = total > 400 and frac < 0.1
    print("OK" if ok else "FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
