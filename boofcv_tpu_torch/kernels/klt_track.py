"""Pyramidal KLT tracking of N features in one CUDA kernel launch.

Counterpart of the pair ``boofcv_tpu/kernels/window_gather.py`` (the TPU
window gather) and ``boofcv_tpu/feature/klt.py`` (the level loop XLA fused
around it): ``csrc/klt_track.cu`` gathers each track's window into shared
memory and runs the Gauss-Newton iterations of every pyramid level on it,
so no ``[N, wy, wx]`` window tensor exists in device memory.

This module holds only the CUDA route.  The plain PyTorch version of the
same function is ``feature.klt.track_pyramid_reference``;
``feature.klt.track_pyramid`` sends CPU tensors there and CUDA tensors here.
A build or launch failure raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence

import torch

MAX_LEVELS = 8    # KLT_MAX_LEVELS in csrc/klt_track.cu
MAX_RADIUS = 7    # 15x15 patch: eight pixels per lane

_launches = 0


def launch_count() -> int:
    """Number of kernel launches since import or the last reset."""
    return _launches


def reset_launch_count() -> None:
    global _launches
    _launches = 0


class _Levels(ctypes.Structure):
    """``KltLevels`` of csrc/klt_track.cu."""
    _fields_ = [("img", ctypes.c_void_p * MAX_LEVELS),
                ("desc", ctypes.c_void_p * MAX_LEVELS),
                ("gx", ctypes.c_void_p * MAX_LEVELS),
                ("gy", ctypes.c_void_p * MAX_LEVELS),
                ("h", ctypes.c_int * MAX_LEVELS),
                ("w", ctypes.c_int * MAX_LEVELS),
                ("ratio", ctypes.c_float * MAX_LEVELS),
                ("top_scale", ctypes.c_float),
                ("n_levels", ctypes.c_int)]


class _Params(ctypes.Structure):
    """``KltParams`` of csrc/klt_track.cu."""
    _fields_ = [("n", ctypes.c_int),
                ("radius", ctypes.c_int),
                ("max_iterations", ctypes.c_int),
                ("max_per_pixel_error", ctypes.c_float),
                ("min_determinant", ctypes.c_float),
                ("convergence_tol", ctypes.c_float)]


@functools.cache
def _kernel_lib():
    """Build (at first use) and load the kernel; declare its C ABI."""
    from boofcv_tpu_torch.kernels._nvcc import load_library
    lib = load_library("klt_track")
    vp = ctypes.c_void_p
    lib.klt_track_launch.argtypes = [ctypes.POINTER(_Levels),
                                     ctypes.POINTER(_Params), vp, vp, vp, vp,
                                     vp, vp, vp]
    lib.klt_track_launch.restype = ctypes.c_int
    lib.klt_track_error_string.argtypes = [ctypes.c_int]
    lib.klt_track_error_string.restype = ctypes.c_char_p
    return lib


def _check(name: str, t: torch.Tensor, shape, dev: torch.device):
    if not isinstance(t, torch.Tensor):
        raise ValueError(f"{name} must be a tensor, got {type(t).__name__}")
    if t.device != dev:
        raise ValueError(f"{name} on {t.device}, ys on {dev}")
    if t.dtype != torch.float32:
        raise ValueError(f"{name} must be float32, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must be {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def klt_track_cuda(pyramid: Sequence[torch.Tensor],
                   desc: Sequence[torch.Tensor],
                   grad_x: Sequence[torch.Tensor],
                   grad_y: Sequence[torch.Tensor],
                   ys: torch.Tensor, xs: torch.Tensor,
                   scales: Sequence[int], template_radius: int,
                   max_iterations: int, max_per_pixel_error: float,
                   min_determinant: float, convergence_tol: float):
    """Launch the kernel.  pyramid[l]: [h_l, w_l]; desc / grad_x /
    grad_y[l]: [N, P, P] with P = 2 * template_radius + 1; ys, xs: [N]
    positions at the scale of level 0; all float32, contiguous, on one CUDA
    device; at most ``MAX_LEVELS`` levels.  Raises on anything else and on
    a failed launch.

    Returns (ys, xs, fault, evals): [N] float32 positions, the int32 fault
    code (the worst over the levels) and the int32 count of patch
    evaluations each track ran, summed over the levels (what the kernel's
    arithmetic bound is counted from)."""
    global _launches
    if not isinstance(ys, torch.Tensor) or ys.device.type != "cuda":
        raise ValueError(f"klt_track_cuda needs CUDA tensors, got ys on "
                         f"{getattr(ys, 'device', type(ys).__name__)}")
    dev = ys.device
    n_levels = len(scales)
    if not 1 <= n_levels <= MAX_LEVELS:
        raise ValueError(f"{n_levels} pyramid levels: the kernel takes 1 to "
                         f"{MAX_LEVELS}")
    if not 1 <= template_radius <= MAX_RADIUS:
        raise ValueError(f"template_radius {template_radius}: the kernel "
                         f"takes 1 to {MAX_RADIUS}")
    if max_iterations < 0:
        raise ValueError(f"max_iterations {max_iterations} is negative")
    for name, seq in (("pyramid", pyramid), ("desc", desc),
                      ("grad_x", grad_x), ("grad_y", grad_y)):
        if len(seq) != n_levels:
            raise ValueError(f"{name} has {len(seq)} levels, scales "
                             f"{n_levels}")
    if ys.dim() != 1:
        raise ValueError(f"ys must be [N], got {tuple(ys.shape)}")
    n = ys.shape[0]
    p = 2 * template_radius + 1
    _check("ys", ys, (n,), dev)
    _check("xs", xs, (n,), dev)
    lv = _Levels()
    for l in range(n_levels):
        img = pyramid[l]
        _check(f"pyramid[{l}]", img, None, dev)
        if img.dim() != 2 or img.shape[0] < 1 or img.shape[1] < 1:
            raise ValueError(f"pyramid[{l}] must be [h, w], got "
                             f"{tuple(img.shape)}")
        lv.img[l] = img.data_ptr()
        lv.h[l], lv.w[l] = img.shape
        for name, seq, field in (("desc", desc, lv.desc),
                                 ("grad_x", grad_x, lv.gx),
                                 ("grad_y", grad_y, lv.gy)):
            _check(f"{name}[{l}]", seq[l], (n, p, p), dev)
            field[l] = seq[l].data_ptr()
        lv.ratio[l] = scales[l] / scales[l - 1] if l > 0 else 1.0
    lv.top_scale = float(scales[-1])
    lv.n_levels = n_levels
    prm = _Params(n, template_radius, max_iterations, max_per_pixel_error,
                  min_determinant, convergence_tol)

    out_y = torch.empty((n,), dtype=torch.float32, device=dev)
    out_x = torch.empty((n,), dtype=torch.float32, device=dev)
    fault = torch.empty((n,), dtype=torch.int32, device=dev)
    evals = torch.empty((n,), dtype=torch.int32, device=dev)
    if n > 0:
        lib = _kernel_lib()
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = lib.klt_track_launch(
                ctypes.byref(lv), ctypes.byref(prm), ys.data_ptr(),
                xs.data_ptr(), out_y.data_ptr(), out_x.data_ptr(),
                fault.data_ptr(), evals.data_ptr(), stream)
        if err != 0:
            msg = lib.klt_track_error_string(err).decode()
            raise RuntimeError(f"klt_track launch failed: {msg} ({err})")
        _launches += 1
    return out_y, out_x, fault, evals
