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

from boofcv_tpu_torch.kernels.window_gather import plane_stride

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
                ("stride", ctypes.c_longlong * MAX_LEVELS),
                ("h", ctypes.c_int * MAX_LEVELS),
                ("w", ctypes.c_int * MAX_LEVELS),
                ("ratio", ctypes.c_float * MAX_LEVELS),
                ("top_scale", ctypes.c_float),
                ("n_levels", ctypes.c_int)]


class _Params(ctypes.Structure):
    """``KltParams`` of csrc/klt_track.cu."""
    _fields_ = [("n", ctypes.c_int),
                ("per_stream", ctypes.c_int),
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
    if tuple(t.shape) != tuple(shape):
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
    """Launch the kernel, once.  pyramid[l]: [h_l, w_l]; desc / grad_x /
    grad_y[l]: [N, P, P] with P = 2 * template_radius + 1; ys, xs: [N]
    positions at the scale of level 0.  Or B streams: ys, xs [B, N],
    templates [B, N, P, P], pyramid[l] [B, h_l, w_l], each level a
    contiguous stack or one frame expanded over the streams (see
    ``window_gather.plane_stride``).  All float32, contiguous, on one CUDA
    device; at most ``MAX_LEVELS`` levels.  Raises on anything else and on
    a failed launch.

    Returns (ys, xs, fault, evals) shaped like ``ys``: float32 positions,
    the int32 fault code (the worst over the levels) and the int32 count of
    patch evaluations each track ran, summed over the levels (what the
    kernel's arithmetic bound is counted from)."""
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
    if ys.dim() not in (1, 2):
        raise ValueError(f"ys must be [N] or [B, N], got {tuple(ys.shape)}")
    shape = tuple(ys.shape)
    p = 2 * template_radius + 1
    _check("ys", ys, shape, dev)
    _check("xs", xs, shape, dev)
    lv = _Levels()
    for l in range(n_levels):
        img = pyramid[l]
        if not isinstance(img, torch.Tensor):
            raise ValueError(f"pyramid[{l}] must be a tensor, got "
                             f"{type(img).__name__}")
        if img.device != dev:
            raise ValueError(f"pyramid[{l}] on {img.device}, ys on {dev}")
        lv.stride[l] = plane_stride(f"pyramid[{l}]", img)
        if img.shape[:-2] != shape[:-1]:
            raise ValueError(f"pyramid[{l}] is {tuple(img.shape)} for ys "
                             f"{shape}")
        lv.img[l] = img.data_ptr()
        lv.h[l], lv.w[l] = img.shape[-2:]
        for name, seq, field in (("desc", desc, lv.desc),
                                 ("grad_x", grad_x, lv.gx),
                                 ("grad_y", grad_y, lv.gy)):
            _check(f"{name}[{l}]", seq[l], shape + (p, p), dev)
            field[l] = seq[l].data_ptr()
        lv.ratio[l] = scales[l] / scales[l - 1] if l > 0 else 1.0
    lv.top_scale = float(scales[-1])
    lv.n_levels = n_levels
    n = ys.numel()
    prm = _Params(n, shape[-1], template_radius, max_iterations,
                  max_per_pixel_error, min_determinant, convergence_tol)

    out_y = torch.empty(shape, dtype=torch.float32, device=dev)
    out_x = torch.empty(shape, dtype=torch.float32, device=dev)
    fault = torch.empty(shape, dtype=torch.int32, device=dev)
    evals = torch.empty(shape, dtype=torch.int32, device=dev)
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
