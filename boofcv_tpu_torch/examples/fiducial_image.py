"""Image-pattern square fiducials: match arbitrary pictures inside
black-bordered squares (port of ``boofcv_tpu/examples/fiducial_image.py``).

Reference analog: examples/fiducial/ExampleFiducialImage.java — an NCC
template library over all 4 rotations.  Oracle: two distinct patterns
placed in a scene are identified with the right IDs and rotations.

    python -m boofcv_tpu_torch.examples.fiducial_image [--device cpu|cuda]
"""

from __future__ import annotations

import numpy as np

from boofcv_tpu_torch._config import resolve_device
from boofcv_tpu_torch.examples import parse_device
from boofcv_tpu_torch.recognition import fiducial_square as fid


def main(argv=None) -> int:
    dev = resolve_device(parse_device(argv))
    rng = np.random.default_rng(2)

    def make_pattern(seed, n=32):
        r = np.random.default_rng(seed)
        from scipy.ndimage import gaussian_filter
        p = gaussian_filter(r.normal(0, 1, (n, n)), 2.0)
        return (127 + 110 * p / np.abs(p).max()).astype(np.float32)

    patterns = [make_pattern(0), make_pattern(1)]

    def render_marker(pattern, size_px=64):
        img = np.zeros((size_px, size_px), np.float32)       # black border
        b = size_px // 4
        inner = size_px - 2 * b
        yi, xi = np.mgrid[0:inner, 0:inner]
        sy = yi * (pattern.shape[0] - 1) / (inner - 1)
        sx = xi * (pattern.shape[1] - 1) / (inner - 1)
        img[b:b + inner, b:b + inner] = pattern[sy.astype(int),
                                                sx.astype(int)]
        return img

    scene = np.full((200, 300), 255.0, np.float32)
    scene[30:94, 40:104] = render_marker(patterns[0])
    m1 = np.rot90(render_marker(patterns[1]), 1)             # rotated 90
    scene[100:164, 180:244] = m1
    scene += rng.normal(0, 2.0, scene.shape)

    dets = fid.detect_image(scene, patterns, device=dev)
    print(f"device: {dev}")
    print(f"detections: {[(d['id'], d['rotation']) for d in dets]}")
    ids = sorted(d["id"] for d in dets)
    ok = len(dets) == 2 and ids == [0, 1] \
        and any(d["id"] == 1 and d["rotation"] != 0 for d in dets)
    print("OK" if ok else "FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
