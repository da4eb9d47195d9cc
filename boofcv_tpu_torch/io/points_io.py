"""Point-cloud I/O: PLY codec (port of ``boofcv_tpu/io/points_io.py``,
numpy only; files written byte-equal to the reference's).

Reference analog: boofcv-io io/points/PointCloudIO + impl/PlyCodec_F64.java
(ascii + binary little-endian PLY with optional per-vertex color).
"""

from __future__ import annotations

import struct

import numpy as np


def save_ply(path: str, points: np.ndarray, colors: np.ndarray | None = None,
             binary: bool = True) -> None:
    """points: [N, 3] float; colors: optional [N, 3] uint8."""
    points = np.asarray(points, np.float64)
    n = points.shape[0]
    has_c = colors is not None
    header = ["ply",
              "format binary_little_endian 1.0" if binary else "format ascii 1.0",
              f"element vertex {n}",
              "property double x", "property double y", "property double z"]
    if has_c:
        colors = np.asarray(colors, np.uint8)
        header += ["property uchar red", "property uchar green",
                   "property uchar blue"]
    header += ["end_header"]
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode())
        if binary:
            if has_c:
                rec = np.zeros(n, dtype=[("xyz", "<f8", 3), ("rgb", "u1", 3)])
                rec["xyz"] = points
                rec["rgb"] = colors
                f.write(rec.tobytes())
            else:
                f.write(points.astype("<f8").tobytes())
        else:
            for i in range(n):
                row = " ".join(repr(float(v)) for v in points[i])
                if has_c:
                    row += " " + " ".join(str(int(v)) for v in colors[i])
                f.write((row + "\n").encode())


def load_ply(path: str):
    """Returns (points [N, 3] f64, colors [N, 3] u8 or None)."""
    with open(path, "rb") as f:
        data = f.read()
    head_end = data.index(b"end_header\n") + len(b"end_header\n")
    header = data[:head_end].decode().splitlines()
    n = 0
    fmt = "ascii"
    props = []
    for line in header:
        parts = line.split()
        if not parts:
            continue
        if parts[0] == "format":
            fmt = parts[1]
        elif parts[0] == "element" and parts[1] == "vertex":
            n = int(parts[2])
        elif parts[0] == "property" and len(parts) == 3:
            props.append((parts[1], parts[2]))
    names = [p[1] for p in props]
    has_c = "red" in names
    body = data[head_end:]
    typemap = {"double": "<f8", "float": "<f4", "float64": "<f8",
               "float32": "<f4", "uchar": "u1", "uint8": "u1"}
    if fmt.startswith("binary"):
        dt = np.dtype([(nm, typemap[t]) for t, nm in props])
        rec = np.frombuffer(body, dtype=dt, count=n)
        pts = np.stack([rec["x"], rec["y"], rec["z"]], 1).astype(np.float64)
        cols = (np.stack([rec["red"], rec["green"], rec["blue"]], 1)
                if has_c else None)
    else:
        rows = body.decode().split("\n")[:n]
        vals = np.array([[float(x) for x in r.split()] for r in rows])
        pts = vals[:, :3]
        cols = vals[:, 3:6].astype(np.uint8) if has_c else None
    return pts, cols
