"""RGB-D depth image to a colored 3D point cloud (port of
``boofcv_tpu/examples/depth_point_cloud.py``).

Reference analog: examples/sfm/ExampleDepthPointCloud.java — lift every
depth pixel through the pinhole model.  Oracle: the cloud from an exact
synthetic depth map of a tilted plane reproduces the plane equation. The JAX
example's ``--tpu`` flag and ``setup_backend`` have no counterpart:
``--device`` picks the device.

    python -m boofcv_tpu_torch.examples.depth_point_cloud [--device cpu|cuda]
"""

from __future__ import annotations

import numpy as np
import torch

from boofcv_tpu_torch._config import resolve_device
from boofcv_tpu_torch.examples import parse_device

H, W, F = 120, 160, 150.0


def _scene():
    """(plane normal n, offset d, the plane's z image [H, W] float32): the
    plane n . X = d, n = (0.1, -0.2, 1)/|.|, through (0, 0, 5)."""
    n = np.array([0.1, -0.2, 1.0])
    n /= np.linalg.norm(n)
    d = n @ np.array([0, 0, 5.0])
    ys, xs = np.mgrid[0:H, 0:W].astype(np.float64)
    rays = np.stack([(xs - W / 2) / F, (ys - H / 2) / F, np.ones_like(xs)],
                    -1)
    Xc = rays * (d / (rays @ n))[..., None]      # points on the plane
    return n, d, Xc[..., 2].astype(np.float32)


def main(argv=None) -> int:
    dev = resolve_device(parse_device(argv))
    n, d, z = _scene()
    cx, cy = W / 2, H / 2
    zimg = torch.as_tensor(z, device=dev)
    # lift back on the device: one elementwise program
    yj, xj = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=dev),
                            torch.arange(W, dtype=torch.float32, device=dev),
                            indexing="ij")
    X = torch.stack([(xj - cx) / F * zimg, (yj - cy) / F * zimg, zimg], -1)
    cloud = X.cpu().numpy().reshape(-1, 3)
    print(f"device: {dev}")
    resid = np.abs(cloud @ n - d)
    print(f"cloud points: {len(cloud)}, plane residual max "
          f"{resid.max():.2e}, depth range {cloud[:, 2].min():.2f}.."
          f"{cloud[:, 2].max():.2f} m")
    ok = resid.max() < 1e-3 and len(cloud) == H * W
    print("OK" if ok else "FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
