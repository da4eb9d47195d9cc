"""Detect a binary square fiducial and estimate its 6-DoF pose (port of
``boofcv_tpu/examples/fiducial_pose.py``).

Reference analog: examples/fiducial/ExampleFiducialBinary.java — binary
square marker detect -> decode id -> pose from the quad.  The marker is
placed in a synthetic scene; the decoded id and reprojected corners are
checked. The JAX example's ``--tpu`` flag and ``setup_backend`` have no
counterpart: ``--device`` picks the device.

    python -m boofcv_tpu_torch.examples.fiducial_pose [--device cpu|cuda]
"""

from __future__ import annotations

import numpy as np

from boofcv_tpu_torch._config import resolve_device
from boofcv_tpu_torch.examples import parse_device
from boofcv_tpu_torch.recognition import fiducial_square as fid

MARKER_ID = 451
MARKER_SIZE = 0.2


def _scene():
    """Marker 451 (12 px cells) pasted on grey, sigma-3 noise."""
    rng = np.random.default_rng(7)
    img = fid.encode_marker(MARKER_ID, cells_px=12)
    scene = np.full((260, 340), 170.0, np.float32)
    y0, x0 = 60, 90
    scene[y0:y0 + img.shape[0], x0:x0 + img.shape[1]] = img
    scene += rng.normal(0, 3, scene.shape)
    return scene


def main(argv=None) -> int:
    dev = resolve_device(parse_device(argv))
    scene = _scene()
    dets = fid.detect(scene, device=dev)
    print(f"device: {dev}")
    print(f"detections: {len(dets)}")
    if len(dets) != 1 or dets[0]["id"] != MARKER_ID:
        print("FAILED")
        return 1
    corners = dets[0]["corners"]
    print(f"decoded id: {dets[0]['id']}")
    f = 400.0
    K = np.array([[f, 0, scene.shape[1] / 2], [0, f, scene.shape[0] / 2],
                  [0, 0, 1.0]])
    R, t = fid.estimate_pose(corners, marker_size=MARKER_SIZE, K=K,
                             device=dev)
    s = MARKER_SIZE / 2
    world = np.array([[-s, -s, 0], [s, -s, 0], [s, s, 0], [-s, s, 0.0]])
    pc = world @ R.T + t
    proj = (pc / pc[:, 2:]) @ K.T
    err = float(np.abs(proj[:, :2] - corners).max())
    print(f"pose: distance {t[2]:.3f} m, corner reprojection err {err:.2f} px")
    ok = err < 1.5 and t[2] > 0
    print("OK" if ok else "FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
