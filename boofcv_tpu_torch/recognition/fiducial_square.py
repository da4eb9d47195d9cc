"""Square binary fiducial markers (port of
``boofcv_tpu/recognition/fiducial_square.py``).

Reference analog: boofcv-recognition alg/fiducial/square/ —
BaseDetectFiducialSquare.java (binary quad detection -> homography
unwarp -> decode), DetectFiducialSquareBinary.java (grid-of-bits payload
with orientation disambiguation), QuadPoseEstimator.java (PnP pose from
the 4 corners).

Marker layout (as the reference's binary square): a black border of
``border_fraction`` on each side, inner ``grid x grid`` cells encoding
the ID; orientation resolved by trying all 4 rotations against the
encoding constraint (reference uses corner cells).

Device and host: Otsu and the threshold run on the device; contours,
polygon fits, cell sampling and decoding in numpy on the host.  The
unit-square homographies of all the quads of one image are fitted as one
batched DLT (one host sync, where the reference fits one a quad; the same
homographies).  The cell sampling is the reference's loop as arrays: the
same float64 homography arithmetic and divide, the same clamp and
round-half-to-even, the same float32 running sum in the loop's order.
"""

from __future__ import annotations

import numpy as np
import torch

from boofcv_tpu_torch._config import resolve_device
from boofcv_tpu_torch.feature import shapes
from boofcv_tpu_torch.geo import pnp
from boofcv_tpu_torch.ip import binary as bin_mod
from boofcv_tpu_torch.ip import threshold as th_mod
from boofcv_tpu_torch.recognition import homographies, image_on_device

GRID = 4          # payload cells per side (16 bits incl. orientation cells)
BORDER = 0.25     # black border fraction per side
_UNIT_SQUARE = np.array([[0.0, 0.0], [1.0, 0.0], [1.0, 1.0], [0.0, 1.0]])


def encode_marker(marker_id: int, cells_px: int = 16) -> np.ndarray:
    """Render a square marker image (white background 255, marker black
    border 0).  12 payload bits (corner cells fixed for orientation:
    TL=1, TR=0, BR=0, BL=0 in cell coords)."""
    g = GRID
    n_border = int(round(g * BORDER / (1 - 2 * BORDER)))  # cells of border
    n_border = max(n_border, 1)
    total = g + 2 * n_border
    cells = np.zeros((total, total), np.uint8)  # 0 = black
    inner = np.zeros((g, g), np.uint8)
    # corner orientation cells
    inner[0, 0] = 1
    payload_positions = [(r, c) for r in range(g) for c in range(g)
                         if (r, c) not in ((0, 0), (0, g - 1),
                                           (g - 1, 0), (g - 1, g - 1))]
    bits = [(marker_id >> i) & 1 for i in range(len(payload_positions))]
    for (r, c), b in zip(payload_positions, bits):
        inner[r, c] = b
    cells[n_border:n_border + g, n_border:n_border + g] = inner
    img = np.kron(cells, np.ones((cells_px, cells_px), np.uint8)) * 255
    # white margin around the marker
    m = cells_px * 2
    out = np.full((img.shape[0] + 2 * m, img.shape[1] + 2 * m), 255, np.uint8)
    out[m:-m, m:-m] = img
    return out.astype(np.float32)


def max_marker_id() -> int:
    return 2 ** (GRID * GRID - 4) - 1


def _sample_cells(gray, H, n_border):
    """Unwarp the quad (unit square -> image homography ``H``) and
    average-sample every cell: 4x4 samples a cell, nearest pixel."""
    g = GRID
    total = g + 2 * n_border
    S = 4  # samples per cell per axis
    h, w = gray.shape
    r = np.arange(total)[:, None, None, None]
    c = np.arange(total)[None, :, None, None]
    sy = np.arange(S)[None, None, :, None]
    sx = np.arange(S)[None, None, None, :]
    u, v = np.broadcast_arrays((c + (sx + 0.5) / S) / total,
                               (r + (sy + 0.5) / S) / total)
    # H @ [u, v, 1], row by row, then the divide
    p = [H[i, 0] * u + H[i, 1] * v + H[i, 2] * 1.0 for i in range(3)]
    x = p[0] / p[2]
    y = p[1] / p[2]
    xi = np.round(np.clip(x, 0, w - 1)).astype(np.int64)
    yi = np.round(np.clip(y, 0, h - 1)).astype(np.int64)
    g_s = gray[yi, xi]                           # [total, total, S, S]
    # the reference's running sum: float32 (NumPy's scalar promotion),
    # sample row by sample row
    acc = np.zeros((total, total), np.float32)
    for a in range(S):
        for b in range(S):
            acc = acc + g_s[:, :, a, b]
    return (acc / (S * S)).astype(np.float64)


def _decode_cells(vals, n_border):
    g = GRID
    total = g + 2 * n_border
    t = (vals.max() + vals.min()) / 2.0
    bits = vals > t   # True = white
    # border must be black
    border_cells = np.ones((total, total), bool)
    border_cells[n_border:-n_border, n_border:-n_border] = False
    if bits[border_cells].mean() > 0.15:
        return None
    inner = bits[n_border:-n_border, n_border:-n_border].astype(int)
    # orientation: rotate until TL=1 and other corners 0
    for rot in range(4):
        cand = np.rot90(inner, -rot)
        corners = (cand[0, 0], cand[0, -1], cand[-1, -1], cand[-1, 0])
        if corners == (1, 0, 0, 0):
            payload_positions = [(r, c) for r in range(g) for c in range(g)
                                 if (r, c) not in ((0, 0), (0, g - 1),
                                                   (g - 1, 0), (g - 1, g - 1))]
            mid = sum(int(cand[r, c]) << i
                      for i, (r, c) in enumerate(payload_positions))
            return mid, rot
    return None


def _quads(image, min_area: float, device):
    """Threshold (device) -> external contours -> convex 4-gons of at
    least ``min_area`` px, clockwise (host).  Returns (host gray, [Q, 4, 2]
    float64 corners, their [Q, 3, 3] unit-square homographies)."""
    img, gray = image_on_device(image, device)
    t = float(th_mod.compute_otsu(img))
    bw = th_mod.threshold(img, t, down=True).cpu().numpy()
    quads = []
    for cont in bin_mod.contour_external(bw):
        if len(cont) < 30:
            continue
        corners = shapes.fit_polygon(cont, num_sides=4, tolerance=3.0)
        if len(corners) != 4 or not shapes.polygon_is_convex(corners):
            continue
        area = 0.5 * abs(sum(
            corners[i][0] * corners[(i + 1) % 4][1]
            - corners[(i + 1) % 4][0] * corners[i][1] for i in range(4)))
        if area < min_area:
            continue
        # ensure clockwise order (y down)
        c = np.asarray(corners, np.float64)
        u = c[1] - c[0]
        v = c[2] - c[1]
        if u[0] * v[1] - u[1] * v[0] < 0:
            c = c[::-1]
        quads.append(c)
    if not quads:
        return gray, [], []
    return gray, quads, homographies(_UNIT_SQUARE, np.stack(quads),
                                     img.device)


def detect(image, min_area: float = 400.0, device=None):
    """Find and decode square fiducials.

    Returns list of dicts {id, corners [4,2] (ordered from the marker's
    TL, clockwise), rotation}.
    """
    gray, quads, Hs = _quads(image, min_area, device)
    n_border = max(int(round(GRID * BORDER / (1 - 2 * BORDER))), 1)
    results = []
    for c, H in zip(quads, Hs):
        dec = _decode_cells(_sample_cells(gray, H, n_border), n_border)
        if dec is None:
            continue
        mid, rot = dec
        c_ordered = np.roll(c, -rot, axis=0)
        results.append({"id": mid, "corners": c_ordered, "rotation": rot})
    return results


def estimate_pose(corners, marker_size: float, K, device=None):
    """Marker pose from its 4 corners (QuadPoseEstimator analog).

    corners: [4, 2] pixels ordered TL, TR, BR, BL; marker_size = physical
    side length.  Returns (R, t) marker->camera as float64 numpy."""
    from boofcv_tpu_torch.calib.zhang99 import extrinsics_from_homography
    dev = resolve_device(device)
    s = marker_size / 2.0
    world = np.array([[-s, -s, 0.0], [s, -s, 0.0], [s, s, 0.0], [-s, s, 0.0]])
    Kinv = np.linalg.inv(np.asarray(K, np.float64))
    px = np.concatenate([corners, np.ones((4, 1))], 1) @ Kinv.T
    obs = px[:, :2]
    # planar PnP: homography decomposition init + GN refine
    Hm = homographies(world[:, :2], obs, dev)
    R, t = extrinsics_from_homography(Hm, np.eye(3))
    T = lambda a: torch.as_tensor(np.asarray(a, np.float64), device=dev)
    R2, t2 = pnp.refine_pnp(T(R), T(t), T(world), T(obs), iterations=15)
    return R2.cpu().numpy(), t2.cpu().numpy()


def _sample_interior(gray, H, size: int, border: float = BORDER):
    """Unwarp the quad's INTERIOR (inside the black border) to a size x
    size grayscale patch via the unit-square homography ``H``."""
    h, w = gray.shape
    u = border + (1 - 2 * border) * (np.arange(size) + 0.5) / size
    uu, vv = np.meshgrid(u, u)
    P = np.stack([uu, vv, np.ones_like(uu)], -1) @ H.T
    x = np.clip(P[..., 0] / P[..., 2], 0, w - 1)
    y = np.clip(P[..., 1] / P[..., 2], 0, h - 1)
    x0 = np.clip(np.floor(x).astype(int), 0, w - 2)
    y0 = np.clip(np.floor(y).astype(int), 0, h - 2)
    fx = x - x0
    fy = y - y0
    return ((1 - fy) * ((1 - fx) * gray[y0, x0] + fx * gray[y0, x0 + 1])
            + fy * ((1 - fx) * gray[y0 + 1, x0]
                    + fx * gray[y0 + 1, x0 + 1]))


def detect_image(image, patterns, min_area: float = 400.0,
                 min_ncc: float = 0.6, sample_size: int = 32, device=None):
    """Image-pattern square fiducials (SquareImage_to_FiducialDetector /
    DetectFiducialSquareImage.java analog): black-bordered squares whose
    interior is matched by NCC against a library of grayscale patterns,
    over all 4 rotations.

    patterns: list of 2D arrays (any size; resampled to sample_size).
    Returns list of dicts {id, corners [4,2], rotation, ncc}.
    """
    gray, quads, Hs = _quads(image, min_area, device)

    # normalize the pattern library once: [P, 4, S, S] (4 rotations)
    lib = []
    for p in patterns:
        p = np.asarray(p, np.float32)
        ph, pw = p.shape
        yi = (np.arange(sample_size) + 0.5) / sample_size * ph
        xi = (np.arange(sample_size) + 0.5) / sample_size * pw
        ps = p[yi.astype(int)[:, None], xi.astype(int)[None, :]]
        rots = []
        for r in range(4):
            q = np.rot90(ps, r)
            q = (q - q.mean()) / (q.std() + 1e-9)
            rots.append(q)
        lib.append(np.stack(rots))
    lib = np.stack(lib)                                   # [P, 4, S, S]

    results = []
    for c, H in zip(quads, Hs):
        patch = _sample_interior(gray, H, sample_size)
        pn = (patch - patch.mean()) / (patch.std() + 1e-9)
        # NCC against the whole library at once (flattened matmul)
        scores = np.tensordot(lib, pn, axes=([2, 3], [0, 1])) \
            / (sample_size * sample_size)                 # [P, 4]
        pid, rot = np.unravel_index(np.argmax(scores), scores.shape)
        best = float(scores[pid, rot])
        if best < min_ncc:
            continue
        results.append({"id": int(pid),
                        "corners": np.roll(c, -int(rot), axis=0),
                        "rotation": int(rot), "ncc": best})
    return results
