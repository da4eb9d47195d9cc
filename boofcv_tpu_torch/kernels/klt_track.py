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
import struct
from typing import Sequence

import torch

from boofcv_tpu_torch.kernels import _nvcc
from boofcv_tpu_torch.kernels.window_gather import plane_stride

MAX_LEVELS = 8    # KLT_MAX_LEVELS in csrc/klt_track.cu
MAX_RADIUS = 7    # 15x15 patch: eight pixels per lane


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


class _Buffers(ctypes.Structure):
    """``KltBuffers`` of csrc/klt_track.cu."""
    _fields_ = [(name, ctypes.c_void_p) for name in
                ("ys", "xs", "out_y", "out_x", "out_fault", "out_evals")]


# Each struct is filled in one struct.pack_into, field order and sizes as
# above (checked against ctypes' layout at import), into this thread's own.
_LEVELS_FMT = struct.Struct(f"=32Q{MAX_LEVELS}q{MAX_LEVELS}i{MAX_LEVELS}i"
                            f"{MAX_LEVELS}ffi")
_PARAMS_FMT = struct.Struct("=4i3f")
_BUFFERS_FMT = struct.Struct("=6Q")
assert _LEVELS_FMT.size == ctypes.sizeof(_Levels)
assert _PARAMS_FMT.size == ctypes.sizeof(_Params)
assert _BUFFERS_FMT.size == ctypes.sizeof(_Buffers)
# -fmad=false: no products and sums contracted into FMA, so the kernel rounds
# each one as the plain version does (csrc/klt_track.cu's build note)
_KERNEL = _nvcc.Kernel("klt_track", (_Levels, _Params, _Buffers),
                       flags=("-fmad=false",))
launch_count = _KERNEL.launch_count
reset_launch_count = _KERNEL.reset_launch_count
_F32 = torch.float32


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


def _explain(pyramid, desc, grad_x, grad_y, ys, xs, n_levels, p) -> None:
    """Raise the ValueError that names what the fast checks of
    :func:`klt_track_cuda` refused."""
    dev = ys.device
    for name, seq in (("pyramid", pyramid), ("desc", desc),
                      ("grad_x", grad_x), ("grad_y", grad_y)):
        if len(seq) != n_levels:
            raise ValueError(f"{name} has {len(seq)} levels, scales "
                             f"{n_levels}")
    if ys.dim() not in (1, 2):
        raise ValueError(f"ys must be [N] or [B, N], got {tuple(ys.shape)}")
    shape = tuple(ys.shape)
    _check("ys", ys, shape, dev)
    _check("xs", xs, shape, dev)
    for l in range(n_levels):
        img = pyramid[l]
        if not isinstance(img, torch.Tensor):
            raise ValueError(f"pyramid[{l}] must be a tensor, got "
                             f"{type(img).__name__}")
        if img.device != dev:
            raise ValueError(f"pyramid[{l}] on {img.device}, ys on {dev}")
        plane_stride(f"pyramid[{l}]", img)
        if img.shape[:-2] != shape[:-1]:
            raise ValueError(f"pyramid[{l}] is {tuple(img.shape)} for ys "
                             f"{shape}")
        for name, seq in (("desc", desc), ("grad_x", grad_x),
                          ("grad_y", grad_y)):
            _check(f"{name}[{l}]", seq[l], shape + (p, p), dev)
    raise ValueError("klt_track_cuda: inputs refused")  # not reached


def _pack(pyramid, desc, grad_x, grad_y, ys, xs, scales, template_radius,
          max_iterations, max_per_pixel_error, min_determinant,
          convergence_tol) -> tuple:
    """Check the arguments of :func:`klt_track_cuda` (on any device: the
    tensors must share ``ys``'s) and fill this thread's ``KltLevels`` and
    ``KltParams`` from them.  Returns (ys's device index, ys's shape,
    tracks in all); raises ValueError on anything the kernel does not
    take."""
    n_levels = len(scales)
    if not 1 <= n_levels <= MAX_LEVELS:
        raise ValueError(f"{n_levels} pyramid levels: the kernel takes 1 to "
                         f"{MAX_LEVELS}")
    if not 1 <= template_radius <= MAX_RADIUS:
        raise ValueError(f"template_radius {template_radius}: the kernel "
                         f"takes 1 to {MAX_RADIUS}")
    if max_iterations < 0:
        raise ValueError(f"max_iterations {max_iterations} is negative")
    p = 2 * template_radius + 1
    # fast checks, one pass; anything refused is explained by _explain
    idx = ys.get_device()
    shape = ys.shape
    lead = shape[:-1]
    tshape = shape + (p, p)
    ptrs = [0] * (4 * MAX_LEVELS)
    geo = [0] * (3 * MAX_LEVELS)
    f32 = _F32
    try:
        ok = (len(pyramid) == n_levels and len(desc) == n_levels
              and len(grad_x) == n_levels and len(grad_y) == n_levels
              and 1 <= len(shape) <= 2 and xs.shape == shape
              and ys.dtype is f32 and xs.dtype is f32
              and xs.get_device() == idx and ys.is_contiguous()
              and xs.is_contiguous())
        for l in range(n_levels if ok else 0):
            img, d, g1, g2 = pyramid[l], desc[l], grad_x[l], grad_y[l]
            ish = img.shape
            h, w = ish[-2:]
            st = img.stride()
            stride = 0 if len(ish) == 2 or ish[0] == 1 else st[0]
            if not (img.dtype is f32 and d.dtype is f32 and g1.dtype is f32
                    and g2.dtype is f32 and img.get_device() == idx
                    and d.get_device() == idx and g1.get_device() == idx
                    and g2.get_device() == idx and ish[:-2] == lead
                    and ish.numel() > 0 and st[-1] == 1 and st[-2] == w
                    and (stride == 0 or stride == h * w)
                    and d.shape == tshape and g1.shape == tshape
                    and g2.shape == tshape and d.is_contiguous()
                    and g1.is_contiguous() and g2.is_contiguous()):
                ok = False
                break
            ptrs[l] = img.data_ptr()
            ptrs[MAX_LEVELS + l] = d.data_ptr()
            ptrs[2 * MAX_LEVELS + l] = g1.data_ptr()
            ptrs[3 * MAX_LEVELS + l] = g2.data_ptr()
            geo[l] = stride
            geo[MAX_LEVELS + l] = h
            geo[2 * MAX_LEVELS + l] = w
    except (AttributeError, TypeError, ValueError):
        ok = False
    if not ok:
        _explain(pyramid, desc, grad_x, grad_y, ys, xs, n_levels, p)
    ratio = [scales[l] / scales[l - 1] if 0 < l < n_levels else 1.0
             for l in range(MAX_LEVELS)]
    (lv, prm, _), _ = _KERNEL.structs()
    _LEVELS_FMT.pack_into(lv, 0, *ptrs, *geo, *ratio, float(scales[-1]),
                          n_levels)
    n = ys.numel()
    _PARAMS_FMT.pack_into(prm, 0, n, shape[-1], template_radius,
                          max_iterations, max_per_pixel_error,
                          min_determinant, convergence_tol)
    return idx, shape, n


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
    if not isinstance(ys, torch.Tensor) or not ys.is_cuda:
        raise ValueError(f"klt_track_cuda needs CUDA tensors, got ys on "
                         f"{getattr(ys, 'device', type(ys).__name__)}")
    idx, shape, n = _pack(pyramid, desc, grad_x, grad_y, ys, xs, scales,
                          template_radius, max_iterations,
                          max_per_pixel_error, min_determinant,
                          convergence_tol)
    # one allocation for the four outputs: y, x, fault, evals
    out = torch.empty((4,) + tuple(shape), dtype=_F32, device=ys.device)
    out_y, out_x, fault, evals = out.unbind(0)
    if n > 0:
        base = out.data_ptr()
        (_, _, buf), _ = _KERNEL.structs()
        _BUFFERS_FMT.pack_into(buf, 0, ys.data_ptr(), xs.data_ptr(), base,
                               base + 4 * n, base + 8 * n, base + 12 * n)
        _KERNEL.launch(idx)
    return out_y, out_x, fault.view(torch.int32), evals.view(torch.int32)
