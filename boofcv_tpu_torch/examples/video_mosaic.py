"""Build a mosaic from a long panning video, rotation and translation
(port of ``boofcv_tpu/examples/video_mosaic.py``).

Reference analog: examples/sfm/ExampleVideoMosaic.java — unlike the
four-frame stitching demo, this drives the Stitcher (KLT through
``klt_track``) through a 14-frame camera sweep with slow rotation,
exercising drift accumulation and re-tracking.  Oracle: the accumulated
homography drift at a probe point stays small over the whole sweep and
the mosaic covers the swept area.  The JAX example's ``--tpu`` flag and
``setup_backend`` have no counterpart: ``--device`` picks the device.

    python -m boofcv_tpu_torch.examples.video_mosaic [--device cpu|cuda]
"""

from __future__ import annotations

import numpy as np
import torch

from boofcv_tpu_torch._config import resolve_device
from boofcv_tpu_torch.examples import parse_device
from boofcv_tpu_torch.io import simulate
from boofcv_tpu_torch.ip import distort
from boofcv_tpu_torch.sfm import stitch2d

FH, FW = 120, 150


def _scene():
    """(frame -> texture affines [(A, b)], float32 frames): a sweep with
    translation and slow in-plane rotation about the frame centre, each
    frame warped from the big texture on the host."""
    rng = np.random.default_rng(5)
    tex = torch.from_numpy(simulate.noise_texture(rng, size=560, octaves=5))
    frames, gt = [], []
    for i in range(14):
        ang = 0.012 * i
        dy, dx = 3.0 * i, 14.0 * i
        c, s = np.cos(ang), np.sin(ang)
        # dst->src map for the warp: texture coords of frame pixel (x, y)
        A = np.array([[c, -s], [s, c]])
        b = np.array([dx + 30, dy + 30]) - A @ np.array([FW / 2, FH / 2]) \
            + np.array([FW / 2, FH / 2])
        Hm = np.eye(3)
        Hm[:2, :2] = A
        Hm[:2, 2] = b
        frames.append(distort.warp_homography(
            tex, torch.from_numpy(Hm), (FH, FW)).numpy())
        gt.append((A, b))
    return gt, frames


def main(argv=None) -> int:
    dev = resolve_device(parse_device(argv))
    gt, frames = _scene()
    print(f"device: {dev}")

    st = stitch2d.Stitcher(mosaic_h=260, mosaic_w=420, offset=(30.0, 30.0),
                           num_tracks=250, device=dev)
    for f in frames:
        if not st.process(f):
            print("FAILED (lost registration)")
            return 1

    # probe: frame 13's centre must land where its texture content says;
    # the mosaic is anchored to frame 0 (+offset), whose pixel of texture
    # position p is p - (30, 30)
    A, b = gt[-1]
    probe = np.array([FW / 2, FH / 2])
    expected = A @ probe + b - np.array([30, 30]) + np.array([30, 30])
    p = st.H_mosaic_from_frame @ np.array([probe[0], probe[1], 1.0])
    p = p[:2] / p[2]
    drift = np.abs(p - expected).max()
    sweep = 14.0 * 13
    cov = float((st.weight > 0).float().mean())
    print(f"14-frame sweep with rotation: final drift {drift:.2f} px "
          f"({drift / sweep:.1%} of the {sweep:.0f} px sweep), "
          f"mosaic coverage {cov:.0%}")
    ok = drift < 0.05 * sweep and cov > 0.3
    print("OK" if ok else "FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
