"""Native (C++) host-side finishers: g++ build at first use + ctypes
bindings (port of ``boofcv_tpu/native/__init__.py``).

The device path is PyTorch; this package holds the sequential finishers
that BoofCV implements as tight Java loops
(LinearContourLabelChang2004.java:59, LinearExternalContours.java,
SegmentFelzenszwalbHuttenlocher04.java:81, the mean-shift region merge),
compiled from ``ccl.cpp`` (the port's copy of the reference's source) and
``merge.cpp`` (the mean-shift merge, which the reference runs in Python)
into one library in ``_build/`` (git-ignored,
keyed by a hash of the sources and flags, as ``kernels/_nvcc.py`` keys the
CUDA kernels).

Unlike the reference, nothing degrades: a failed build or load raises, and
no environment switch turns the library off.  The pure-Python tracer in
``ip/binary.py``, ``feature/segmentation._fh04_merge_numpy`` and
``feature/segmentation._merge_regions_python`` are kept as the plain
versions the tests hold these against; no caller falls back to them.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_HERE, "ccl.cpp")
MERGE_SOURCE = os.path.join(_HERE, "merge.cpp")
BUILD_DIR = os.path.join(_HERE, "_build")
FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_lib = None

_U8P = ctypes.POINTER(ctypes.c_uint8)
_I32P = ctypes.POINTER(ctypes.c_int32)
_I64P = ctypes.POINTER(ctypes.c_int64)
_F32P = ctypes.POINTER(ctypes.c_float)


def _build() -> str:
    """Path of the shared library for these sources and flags, compiling
    it first when it does not exist yet."""
    sources = (SOURCE, MERGE_SOURCE)
    digest = hashlib.sha256(" ".join(FLAGS).encode())
    for src in sources:
        with open(src, "rb") as f:
            digest.update(f.read())
    out = os.path.join(BUILD_DIR,
                       f"libboofcv_native-{digest.hexdigest()[:16]}.so")
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = ["g++", *FLAGS, *sources, "-o", tmp]
    try:
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=300)
        except (OSError, subprocess.TimeoutExpired) as e:
            raise RuntimeError(f"cannot build {sources}: {' '.join(cmd)}:"
                               f" {e}") from e
        if proc.returncode != 0:
            raise RuntimeError(
                f"g++ failed building {sources} (exit {proc.returncode}):\n"
                f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)       # atomic: concurrent builds agree
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out


def library() -> ctypes.CDLL:
    """The loaded native library, built first if needed; raises when the
    build or the load fails."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(_build())
        lib.boofcv_ccl.restype = ctypes.c_int32
        lib.boofcv_ccl.argtypes = [_U8P, ctypes.c_int32, ctypes.c_int32,
                                   ctypes.c_int32, _I32P]
        lib.boofcv_external_contours.restype = ctypes.c_int32
        lib.boofcv_external_contours.argtypes = [
            _U8P, ctypes.c_int32, ctypes.c_int32, _I32P, ctypes.c_int64,
            _I32P, ctypes.c_int32]
        lib.boofcv_contours_with_holes.restype = ctypes.c_int32
        lib.boofcv_contours_with_holes.argtypes = [
            _U8P, ctypes.c_int32, ctypes.c_int32, _I32P, ctypes.c_int64,
            _I32P, ctypes.c_int32, _I32P]
        lib.boofcv_fh04.restype = ctypes.c_int32
        lib.boofcv_fh04.argtypes = [
            _F32P, _F32P, _F32P, _F32P, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_float, ctypes.c_int32, _I32P]
        lib.boofcv_mean_shift_merge.restype = None
        lib.boofcv_mean_shift_merge.argtypes = [_U8P, _U8P, ctypes.c_int32,
                                                ctypes.c_int32, _I64P]
        _lib = lib
        return _lib


def _binary_u8(binary) -> np.ndarray:
    """A C-contiguous [H, W] uint8 0/1 copy of a 2-D numpy array or CPU
    tensor."""
    img = np.ascontiguousarray(np.asarray(binary) != 0, dtype=np.uint8)
    if img.ndim != 2:
        raise ValueError(f"expected a 2-D binary image, got shape "
                         f"{img.shape}")
    return img


def ccl(binary, eight: bool = True):
    """Union-find connected-component labeling on the host.

    Returns (labels int32 [H, W], count); labels numbered 1..N in raster
    order of each component's first pixel — identical numbering to
    ``ip.binary.label_blobs`` + ``relabel_compact``."""
    lib = library()
    img = _binary_u8(binary)
    h, w = img.shape
    out = np.empty((h, w), dtype=np.int32)
    n = lib.boofcv_ccl(img.ctypes.data_as(_U8P), h, w, int(eight),
                       out.ctypes.data_as(_I32P))
    return out, int(n)


def external_contours(binary):
    """External Moore contours of the raw west-neighbour scan (the
    reference's old fast path, which also emits the walk around each
    interior hole); list of [K, 2] int32 (x, y) arrays."""
    lib = library()
    img = _binary_u8(binary)
    h, w = img.shape
    # every boundary state is visited at most once per direction, so
    # 8*(H+2)*(W+2) bounds the points; a generous first guess, then that
    cap = max(4096, 4 * (h + 2) * (w + 2))
    max_c = max(1024, h * w // 4 + 8)
    for _ in range(2):
        xy = np.empty((cap, 2), dtype=np.int32)
        starts = np.zeros(max_c + 1, dtype=np.int32)
        nc = lib.boofcv_external_contours(
            img.ctypes.data_as(_U8P), h, w, xy.ctypes.data_as(_I32P), cap,
            starts.ctypes.data_as(_I32P), max_c)
        if nc >= 0:
            return [xy[starts[c]:starts[c + 1]].copy() for c in range(nc)]
        cap = 8 * (h + 2) * (w + 2)
        max_c = h * w + 8
    raise RuntimeError("boofcv_external_contours exceeded its hard "
                       "capacity bound")


def contours_with_holes(binary):
    """Full Chang2004 contours (external + internal per blob) with the
    native tracer: one dict per blob, ``{"label": i, "external": [K, 2]
    (x, y), "internal": [[K_j, 2], ...]}``, as
    ``ip.binary.contours_with_holes``."""
    lib = library()
    img = _binary_u8(binary)
    h, w = img.shape
    cap = max(4096, 6 * (h + 2) * (w + 2))
    max_c = max(1024, h * w // 4 + 8)
    for _ in range(2):
        xy = np.empty((cap, 2), dtype=np.int32)
        starts = np.zeros(max_c + 1, dtype=np.int32)
        meta = np.zeros((max_c, 2), dtype=np.int32)
        nc = lib.boofcv_contours_with_holes(
            img.ctypes.data_as(_U8P), h, w, xy.ctypes.data_as(_I32P), cap,
            starts.ctypes.data_as(_I32P), max_c,
            meta.ctypes.data_as(_I32P))
        if nc >= 0:
            n_blobs = int(meta[:nc, 0].max()) if nc else 0
            out = [{"label": i + 1, "external": None, "internal": []}
                   for i in range(n_blobs)]
            for c in range(nc):
                pts = xy[starts[c]:starts[c + 1]].copy()
                lab, kind = int(meta[c, 0]), int(meta[c, 1])
                if kind == 0:
                    if out[lab - 1]["external"] is None:
                        out[lab - 1]["external"] = pts
                else:
                    out[lab - 1]["internal"].append(pts)
            return out
        cap = 10 * (h + 2) * (w + 2)
        max_c = h * w + 8
    raise RuntimeError("boofcv_contours_with_holes exceeded its hard "
                       "capacity bound")


def _f32(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a), dtype=np.float32)


def fh04_merge(wr, wd, wdr=None, wdl=None, k: float = 300.0,
               min_size: int = 20):
    """Felzenszwalb-Huttenlocher sorted-edge union-find merge
    (SegmentFelzenszwalbHuttenlocher04.java:81).

    wr / wd (and the diagonal wdr / wdl, both or neither) are [H, W]
    float32 edge-weight images (numpy or CPU tensors).  Returns (labels
    int32 [H, W] numbered in raster order of each region's first pixel,
    count)."""
    if (wdr is None) != (wdl is None):
        raise ValueError("fh04_merge: provide both diagonal weight images "
                         "(wdr AND wdl) or neither")
    lib = library()
    wr, wd = _f32(wr), _f32(wd)
    h, w = wr.shape
    use_diag = int(wdr is not None)
    wdr, wdl = (_f32(wdr), _f32(wdl)) if use_diag else (wr, wr)
    out = np.empty((h, w), dtype=np.int32)
    n = lib.boofcv_fh04(wr.ctypes.data_as(_F32P), wd.ctypes.data_as(_F32P),
                        wdr.ctypes.data_as(_F32P), wdl.ctypes.data_as(_F32P),
                        h, w, use_diag, float(k), int(min_size),
                        out.ctypes.data_as(_I32P))
    return out, int(n)


def mean_shift_merge(right, down) -> np.ndarray:
    """The roots [H, W] (int64) of the mean-shift region merge: the
    reference's union-find loop over the similarity masks ``right`` (pixel
    i joins i+1) and ``down`` (i joins i+w), [H, W] bool or uint8."""
    lib = library()
    r = _binary_u8(right)
    d = _binary_u8(down)
    h, w = r.shape
    roots = np.empty((h, w), dtype=np.int64)
    lib.boofcv_mean_shift_merge(r.ctypes.data_as(_U8P), d.ctypes.data_as(_U8P),
                                h, w, roots.ctypes.data_as(_I64P))
    return roots
