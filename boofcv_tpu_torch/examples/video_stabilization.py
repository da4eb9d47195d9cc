"""Stabilize a jittery video sequence (port of
``boofcv_tpu/examples/video_stabilization.py``).

Reference analog: examples/geometry/ExampleVideoStabilization.java — the
same KLT (``klt_track``) and robust 2-D motion as mosaicking, but every
frame is warped back into the first frame's coordinates.  Frames are crops
of one texture with random jitter; stabilization must cancel it.  The JAX
example's ``--tpu`` flag and ``setup_backend`` have no counterpart:
``--device`` picks the device.

    python -m boofcv_tpu_torch.examples.video_stabilization [--device cpu|cuda]
"""

from __future__ import annotations

import numpy as np

from boofcv_tpu_torch._config import resolve_device
from boofcv_tpu_torch.examples import parse_device
from boofcv_tpu_torch.io import simulate
from boofcv_tpu_torch.sfm import stitch2d

FH, FW = 120, 160


def _scene():
    """(jitter [(dy, dx)], float32 frames): crops of one texture."""
    rng = np.random.default_rng(23)
    tex = simulate.noise_texture(rng, size=320, octaves=5)
    jitter = [(0, 0)] + [tuple(rng.integers(-6, 7, 2)) for _ in range(5)]
    frames = [tex[40 + dy:40 + dy + FH, 40 + dx:40 + dx + FW]
              .astype(np.float32) for dy, dx in jitter]
    return jitter, frames


def main(argv=None) -> int:
    dev = resolve_device(parse_device(argv))
    jitter, frames = _scene()
    print(f"device: {dev}")

    # stabilization = mosaic into a frame-0-sized canvas: the recovered
    # H_mosaic_from_frame IS the stabilizing warp
    st = stitch2d.Stitcher(mosaic_h=FH, mosaic_w=FW, offset=(0.0, 0.0),
                           num_tracks=200, device=dev)
    ok = True
    for i, f in enumerate(frames):
        if not st.process(f):
            print("FAILED (lost registration)")
            return 1
        Hm = st.H_mosaic_from_frame
        # expected: a pure translation cancelling the jitter
        dy, dx = jitter[i]
        err = max(abs(Hm[0, 2] - dx), abs(Hm[1, 2] - dy))
        print(f"frame {i}: jitter ({dy:+d}, {dx:+d}), "
              f"stabilizing shift ({Hm[1, 2]:+.2f}, {Hm[0, 2]:+.2f}), "
              f"err {err:.2f} px")
        ok &= err < 0.8
    # stabilized frames should align with frame 0 where covered
    stab = st.image()
    diff = np.abs(stab[20:-20, 20:-20] - frames[0][20:-20, 20:-20])
    print(f"stabilized-vs-first median |err|: {np.median(diff):.1f}")
    ok &= np.median(diff) < 8.0
    print("OK" if ok else "FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
