"""Render an orthogonal overhead (bird's-eye) view of the ground plane
(port of ``boofcv_tpu/examples/overhead_view.py``).

Reference analog: examples/sfm/ExampleOverheadView.java —
CreateSyntheticOverheadView maps ground-plane cells through the camera
model.  Oracle: a square ground marking seen obliquely becomes square
(equal side lengths) in the overhead rendering.  This example renders one
view and tracks nothing: it reaches no hand kernel (``sfm/overhead_vo``'s
KLT runs only in ``MonoOverheadVisualOdometry``).  The JAX example's
``--tpu`` flag and ``setup_backend`` have no counterpart: ``--device``
picks the device.

    python -m boofcv_tpu_torch.examples.overhead_view [--device cpu|cuda]
"""

from __future__ import annotations

import numpy as np
import torch

from boofcv_tpu_torch._config import resolve_device
from boofcv_tpu_torch.examples import parse_device
from boofcv_tpu_torch.sfm import overhead_vo

H, W, F = 160, 220, 180.0
K = np.array([[F, 0, W / 2], [0, F, H / 2], [0, 0, 1.0]])
# camera 1.4 m above the plane, pitched down 35 deg, looking +z
PITCH = np.radians(35)
R_PC = np.array([[1, 0, 0],
                 [0, np.cos(PITCH), -np.sin(PITCH)],
                 [0, np.sin(PITCH), np.cos(PITCH)]])
T_PC = np.array([0.0, 1.4, 0.0])


def _scene():
    """The oblique camera image of the JAX example (ray-plane
    intersection): a 1x1 m white square at x in [0.5, 1.5], z in [2.5,
    3.5] on dark ground."""
    def ground_color(px, pz):
        return np.where((np.abs(px - 1.0) < 0.5)
                        & (np.abs(pz - 3.0) < 0.5), 220.0, 40.0)

    ys, xs = np.mgrid[0:H, 0:W].astype(np.float64)
    rays = np.stack([(xs - W / 2) / F, (ys - H / 2) / F,
                     np.ones_like(xs)], -1)
    d_w = rays @ R_PC                      # camera ray in plane frame
    c = -R_PC.T @ T_PC
    s = -c[1] / np.where(np.abs(d_w[..., 1]) < 1e-9, 1e-9, d_w[..., 1])
    Xp = c[None, None] + s[..., None] * d_w
    return np.where(s > 0, ground_color(Xp[..., 0], Xp[..., 2]),
                    10.0).astype(np.float32)


def main(argv=None) -> int:
    dev = resolve_device(parse_device(argv))
    img = _scene()
    omap = overhead_vo.create_overhead_map(
        K, R_PC, T_PC, H, W, oh=250, ow=200, cell=0.02,
        center_x=-1.0, center_z=1.0, device=dev)
    over = overhead_vo.render_overhead(torch.as_tensor(img, device=dev),
                                      omap).cpu().numpy()
    print(f"device: {dev}")

    bright = over > 150
    if not bright.any():
        print("FAILED (no marking)")
        return 1
    ys_b, xs_b = np.nonzero(bright)
    h_ext = ys_b.max() - ys_b.min() + 1
    w_ext = xs_b.max() - xs_b.min() + 1
    fill = bright.sum() / (h_ext * w_ext)
    print(f"overhead marking extent {w_ext} x {h_ext} cells "
          f"(aspect {w_ext / h_ext:.2f}, fill {fill:.2f}); expected a "
          f"filled square of ~50 cells at 2 cm/cell")
    ok = 0.85 < w_ext / h_ext < 1.18 and fill > 0.8 \
        and abs(h_ext - 50) < 8
    print("OK" if ok else "FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
