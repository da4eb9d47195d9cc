"""Batched per-track window gather: a CUDA kernel and its plain version.

Counterpart of ``boofcv_tpu/kernels/window_gather.py``.  The TPU kernel's
alignment contract (8-row-aligned ``oy``, 128-lane tiles, a padded copy of
the image) is Mosaic's and is not carried over: here any integer origin is
accepted and every read is clamped into the image, which is the
edge-replicated window the TPU kernel returns within its contract.

Dispatch is by device, never by failure: a CPU tensor takes
:func:`gather_windows_reference`; a CUDA tensor launches the kernel in
``csrc/window_gather.cu`` (built at first use), and a build or launch
failure raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

_SUBLANES = 8   # row alignment of the KLT window origins (see below)

_launches = 0


def launch_count() -> int:
    """Number of kernel launches since import or the last reset."""
    return _launches


def reset_launch_count() -> None:
    global _launches
    _launches = 0


def gather_windows_reference(image: torch.Tensor, oy: torch.Tensor,
                             ox: torch.Tensor, wy: int,
                             wx: int) -> torch.Tensor:
    """Plain PyTorch version: [N, wy, wx] windows with top-left corners
    (oy, ox), reads clamped into the image (EXTENDED border)."""
    h, w = image.shape
    dev = image.device
    rows = (oy.long()[:, None]
            + torch.arange(wy, device=dev)[None, :]).clamp_(0, h - 1)
    cols = (ox.long()[:, None]
            + torch.arange(wx, device=dev)[None, :]).clamp_(0, w - 1)
    return image[rows[:, :, None], cols[:, None, :]]


@functools.cache
def _kernel_lib():
    """Build (at first use) and load the kernel; declare its C ABI."""
    from boofcv_tpu_torch.kernels._nvcc import load_library
    lib = load_library("window_gather")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.window_gather_launch.argtypes = [vp, ci, ci, vp, vp, ci, ci, ci, vp,
                                         vp]
    lib.window_gather_launch.restype = ci
    lib.window_gather_error_string.argtypes = [ci]
    lib.window_gather_error_string.restype = ctypes.c_char_p
    return lib


def gather_windows_cuda(image: torch.Tensor, oy: torch.Tensor,
                        ox: torch.Tensor, wy: int, wx: int) -> torch.Tensor:
    """Launch the CUDA kernel.  image: [h, w] float32 contiguous; oy, ox:
    [N] int32 contiguous; all on one CUDA device.  Raises on anything else
    and on a failed launch."""
    global _launches
    if image.device.type != "cuda":
        raise ValueError(f"gather_windows_cuda needs CUDA tensors, got "
                         f"image on {image.device}")
    if image.dim() != 2 or image.dtype != torch.float32:
        raise ValueError(f"image must be [h, w] float32, got "
                         f"{tuple(image.shape)} {image.dtype}")
    for name, o in (("oy", oy), ("ox", ox)):
        if o.dim() != 1 or o.dtype != torch.int32:
            raise ValueError(f"{name} must be [N] int32, got "
                             f"{tuple(o.shape)} {o.dtype}")
        if o.device != image.device:
            raise ValueError(f"{name} on {o.device}, image on {image.device}")
        if not o.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if oy.shape[0] != ox.shape[0]:
        raise ValueError(f"oy has {oy.shape[0]} origins, ox {ox.shape[0]}")
    if not image.is_contiguous():
        raise ValueError("image must be contiguous")
    if wy <= 0 or wx <= 0:
        raise ValueError(f"window {wy}x{wx} must be positive")
    h, w = image.shape
    n = oy.shape[0]
    out = torch.empty((n, wy, wx), dtype=torch.float32, device=image.device)
    if n == 0:
        return out
    lib = _kernel_lib()
    with torch.cuda.device(image.device):
        stream = torch.cuda.current_stream(image.device).cuda_stream
        err = lib.window_gather_launch(image.data_ptr(), h, w, oy.data_ptr(),
                                       ox.data_ptr(), n, wy, wx,
                                       out.data_ptr(), stream)
    if err != 0:
        msg = lib.window_gather_error_string(err).decode()
        raise RuntimeError(f"window_gather launch failed: {msg} ({err})")
    _launches += 1
    return out


def gather_windows(image: torch.Tensor, oy: torch.Tensor, ox: torch.Tensor,
                   wy: int = 24, wx: int = 16) -> torch.Tensor:
    """[N, wy, wx] windows of ``image`` with integer top-left corners
    (oy, ox); reads outside the image take the nearest edge pixel.

    CPU tensors take the plain version; CUDA tensors the kernel."""
    if image.device.type == "cpu":
        return gather_windows_reference(image, oy, ox, wy, wx)
    return gather_windows_cuda(image, oy, ox, wy, wx)


def aligned_window_origin(cy: torch.Tensor, cx: torch.Tensor, radius: int,
                          h: int, w: int, wy: int = 24, wx: int = 16):
    """Window origins for float centres (cy, cx) with the (2r+2)-span
    bilinear support inside and room to drift.

    Keeps the reference's 8-row-aligned ``oy``: the origins set the window
    margins, which decide KLT's out-of-bounds faults, so changing them
    changes results against the reference.  Returns (oy, ox) int32 and the
    float in-window patch top-left (py0, px0)."""
    p1 = 2 * radius + 2
    sy = (wy - p1) // 2
    sx = (wx - p1) // 2
    oy_ideal = torch.floor(cy).to(torch.int32) - radius - sy
    oy = torch.clamp((oy_ideal // _SUBLANES) * _SUBLANES, 0,
                     max(((h // _SUBLANES) * _SUBLANES) - wy, 0))
    ox = torch.clamp(torch.floor(cx).to(torch.int32) - radius - sx,
                     0, max(w - wx, 0))
    py0 = cy - radius - oy.to(cy.dtype)
    px0 = cx - radius - ox.to(cx.dtype)
    return oy, ox, py0, px0
