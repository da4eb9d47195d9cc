"""Mono-plane VO drift at 640x480: the JAX reference against the port.

Runs ``chip_smoke.py``'s ``vo_mono_plane:`` scene (a camera translating
parallel to a textured plane 4 m ahead, 17 frames at 640x480, 300 tracks,
pyramid 1/2/4) through ``boofcv_tpu.sfm.mono_plane_vo`` and through
``boofcv_tpu_torch.sfm.mono_plane_vo`` with ``device="cpu"``, on the same
numpy frames, and prints each one's centre error frame by frame, after the
frames that ``chip_smoke.py``'s bar reads and at the end, as a fraction of
the motion.  The card's reading of the same scene is the ``vo_mono_plane:``
line of ``chip_smoke.py``.  Not a test (it takes tens of seconds on a CPU);
run it from the repo's root:

    JAX_PLATFORMS=cpu python tests/reference_mono_plane_drift.py
"""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402
from boofcv_tpu.sfm import mono_plane_vo as jmono  # noqa: E402
from boofcv_tpu_torch.sfm import mono_plane_vo as tmono  # noqa: E402


def run(vo, frames, poses) -> list:
    """The centre error of each frame (m); raises if a frame fails."""
    errs = []
    for frame, (R, t) in zip(frames, poses):
        assert vo.process(frame)
        _, c = vo.camera_to_world()
        errs.append(float(np.linalg.norm(np.asarray(c) - (-R.T @ t))))
    return errs


def main() -> None:
    K, H, W = chip_smoke.K, chip_smoke.H, chip_smoke.W
    n = chip_smoke.FAMILY_FRAMES
    poses, frames = chip_smoke.mono_plane_scene(K, H, W, n)
    total = float(np.linalg.norm(-poses[-1][0].T @ poses[-1][1]))
    for name, make in (
            ("jax", lambda: jmono.MonoPlaneVisualOdometry(
                K, (0.0, 0.0, 1.0), 4.0, num_tracks=chip_smoke.FAMILY_TRACKS)),
            ("port_cpu", lambda: tmono.MonoPlaneVisualOdometry(
                K, (0.0, 0.0, 1.0), 4.0,
                num_tracks=chip_smoke.FAMILY_TRACKS, device="cpu"))):
        t0 = time.perf_counter()
        errs = run(make(), frames, poses)
        # chip_smoke's bar reads the counted run: frames 0 .. n-3
        c = n - 3
        moved = float(np.linalg.norm(-poses[c][0].T @ poses[c][1]))
        print(f"{name}: {W}x{H}, {n} frames, {chip_smoke.FAMILY_TRACKS} "
              f"tracks: centre error after the {c + 1} counted frames "
              f"{errs[c]:.6f} of {moved:.6f} m ({errs[c] / moved:.6f} of the "
              f"motion); final {errs[-1]:.6f} of {total:.6f} m "
              f"({errs[-1] / total:.6f}); per frame "
              f"{[round(e, 6) for e in errs]} ({time.perf_counter() - t0:.1f}"
              " s)")


if __name__ == "__main__":
    main()
