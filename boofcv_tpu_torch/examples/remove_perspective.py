"""Remove perspective distortion from a user-selected quadrilateral (port of
``boofcv_tpu/examples/remove_perspective.py``).

Reference analog: examples/geometry/ExampleRemovePerspectiveDistortion .java
— fit the homography mapping a marked quadrilateral to a fronto- parallel
rectangle and warp.  A textured rectangle is rendered under a known
homography, then recovered. The JAX example's ``--tpu`` flag and
``setup_backend`` have no counterpart: ``--device`` picks the device.

    python -m boofcv_tpu_torch.examples.remove_perspective [--device cpu|cuda]
"""

from __future__ import annotations

import numpy as np
import torch

from boofcv_tpu_torch._config import resolve_device
from boofcv_tpu_torch.examples import parse_device
from boofcv_tpu_torch.geo import epipolar
from boofcv_tpu_torch.io import simulate
from boofcv_tpu_torch.ip import distort

OH, OW = 80, 120
SH, SW = 210, 260
QUAD = np.array([[40.0, 50], [205, 35], [225, 150], [25, 170]])
CORNERS = np.array([[0, 0], [OW - 1.0, 0], [OW - 1, OH - 1], [0, OH - 1]])


def _scene():
    """The "document": a crop of the JAX example's texture."""
    rng = np.random.default_rng(22)
    return (simulate.noise_texture(rng, size=160, octaves=4)[:OH, :OW]
            .astype(np.float32))


def _warp_through(image, Hm, h, w):
    """``image`` sampled at H^-1 (x, y, 1) of every output pixel (float64
    maps, cast to float32 as the JAX example does)."""
    dev = image.device
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float64, device=dev),
                            torch.arange(w, dtype=torch.float64, device=dev),
                            indexing="ij")
    Hinv = torch.as_tensor(np.linalg.inv(Hm), device=dev)
    q = torch.stack([xs, ys, torch.ones_like(xs)], -1) @ Hinv.T
    return distort.warp(image, (q[..., 1] / q[..., 2]).to(torch.float32),
                        (q[..., 0] / q[..., 2]).to(torch.float32))


def main(argv=None) -> int:
    dev = resolve_device(parse_device(argv))
    doc = _scene()
    on = lambda a: torch.as_tensor(a, device=dev)
    # place the document in a larger scene under perspective
    Hm = epipolar.homography_dlt(on(CORNERS[None]),
                                 on(QUAD[None]))[0].cpu().numpy()
    scene = _warp_through(on(doc), Hm, SH, SW)
    # recover: homography from the marked quad back to the rectangle
    Hrec = epipolar.homography_dlt(on(QUAD[None]),
                                   on(CORNERS[None]))[0].cpu().numpy()
    flat = _warp_through(scene, Hrec, OH, OW).cpu().numpy()
    print(f"device: {dev}")
    c = np.s_[6:-6, 6:-6]
    err = np.abs(flat[c] - doc[c])
    print(f"recovered document: median |err| {np.median(err):.1f} "
          f"(texture range {doc.min():.0f}..{doc.max():.0f})")
    ok = np.median(err) < 8.0
    print("OK" if ok else "FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
