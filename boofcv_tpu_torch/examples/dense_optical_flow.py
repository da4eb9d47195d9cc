"""Dense optical flow between two frames (port of
``boofcv_tpu/examples/dense_optical_flow.py``).

Reference analog: examples/features/ExampleDenseOpticalFlow.java — pyramidal
Horn-Schunck / Brox / dense-KLT flow.  The second frame is the first shifted
by a known sub-image offset, so the recovered flow field is checked against
ground truth. The JAX example's ``--tpu`` flag and ``setup_backend`` have no
counterpart: ``--device`` picks the device.

    python -m boofcv_tpu_torch.examples.dense_optical_flow [--device cpu|cuda]
"""

from __future__ import annotations

import numpy as np
import torch

from boofcv_tpu_torch._config import resolve_device
from boofcv_tpu_torch.examples import parse_device
from boofcv_tpu_torch.feature import flow
from boofcv_tpu_torch.io import simulate

DY, DX = 3, 5


def _scene():
    """Two 160x160 crops of one texture, the second (DY, DX) further in."""
    rng = np.random.default_rng(4)
    tex = simulate.noise_texture(rng, size=220, octaves=5)
    return (tex[:160, :160].astype(np.float32),
            tex[DY:160 + DY, DX:160 + DX].astype(np.float32))


def main(argv=None) -> int:
    dev = resolve_device(parse_device(argv))
    im1, im2 = (torch.as_tensor(a, device=dev) for a in _scene())
    print(f"device: {dev}")
    # im2[p] = im1[p + (DY, DX)] => content moves by (-DY, -DX): the
    # ground-truth flow is (u, v) = (-DX, -DY)
    ok = True
    for name, fn in [
        ("horn_schunck_pyr", lambda: flow.horn_schunck_pyramid(
            im1, im2, alpha=0.5, iterations=60)),
        ("dense_klt", lambda: flow.dense_klt(im1, im2, radius=3)),
        ("block_flow", lambda: flow.block_flow(im1, im2, search_radius=8)),
    ]:
        out = fn()
        c = np.s_[30:-30, 30:-30]  # interior (borders have no data)
        mu = float(np.median(out[0].cpu().numpy()[c]))
        mv = float(np.median(out[1].cpu().numpy()[c]))
        err = max(abs(mu + DX), abs(mv + DY))
        ok &= err < 0.7
        print(f"{name:16s}: median flow ({mu:+.2f}, {mv:+.2f}) "
              f"expected ({-DX:+d}, {-DY:+d})  err {err:.2f}")
    print("OK" if ok else "FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
