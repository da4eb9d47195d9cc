"""Stitch a translating image sequence into a mosaic (port of
``boofcv_tpu/examples/image_stitching.py``).

Reference analog: examples/geometry/ExampleImageStitching.java /
ExampleVideoMosaic.java — KLT tracks (``klt_track``) and robust 2-D motion,
then a warp into a common canvas.  Frames are crops of one big texture
sliding by a known offset, so the recovered frame-to-mosaic transforms are
checkable.  The JAX example's ``--tpu`` flag and ``setup_backend`` have no
counterpart: ``--device`` picks the device.

    python -m boofcv_tpu_torch.examples.image_stitching [--device cpu|cuda]
"""

from __future__ import annotations

import numpy as np

from boofcv_tpu_torch._config import resolve_device
from boofcv_tpu_torch.examples import parse_device
from boofcv_tpu_torch.io import simulate
from boofcv_tpu_torch.sfm import stitch2d

SHIFTS = [(0, 0), (4, 10), (8, 20), (12, 30)]


def _scene():
    """130x170 float32 crops of one texture at ``SHIFTS``."""
    rng = np.random.default_rng(2)
    tex = simulate.noise_texture(rng, size=420, octaves=5)
    return [tex[dy:dy + 130, dx:dx + 170].astype(np.float32)
            for dy, dx in SHIFTS]


def main(argv=None) -> int:
    dev = resolve_device(parse_device(argv))
    frames = _scene()
    print(f"device: {dev}")

    st = stitch2d.Stitcher(mosaic_h=220, mosaic_w=260, offset=(20.0, 20.0),
                           num_tracks=200, device=dev)
    errs = []
    for i, f in enumerate(frames):
        if not st.process(f):
            print("FAILED (lost registration)")
            return 1
        Hm = st.H_mosaic_from_frame
        # frame pixel (x, y) shows texture (x + dx, y + dy); the mosaic is
        # anchored to frame 0 at +offset, so it lands at (x + dx + 20, ...)
        dy, dx = SHIFTS[i]
        p = Hm @ np.array([10.0, 10.0, 1.0])
        p = p[:2] / p[2]
        exp = np.array([10.0 + 20 + dx, 10.0 + 20 + dy])
        errs.append(float(np.abs(p - exp).max()))
        print(f"frame {i}: |mosaic_pos - expected|_max = {errs[-1]:.2f} px")

    cov = float((st.weight > 0).float().mean())
    print(f"mosaic coverage: {cov*100:.0f}% of canvas")
    ok = max(errs) < 1.5 and cov > 0.4
    print("OK" if ok else "FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
