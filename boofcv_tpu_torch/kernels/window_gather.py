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
    """Plain PyTorch version: [N, wy, wx] windows of an [h, w] image with
    top-left corners (oy, ox) [N], reads clamped into the image (EXTENDED
    border); or [B, N, wy, wx] windows of [B, h, w] images at [B, N]
    corners, stream b's windows from image b."""
    h, w = image.shape[-2:]
    lead = image.shape[:-2]
    dev = image.device
    rows = (oy.long()[..., None]
            + torch.arange(wy, device=dev)).clamp_(0, h - 1)
    cols = (ox.long()[..., None]
            + torch.arange(wx, device=dev)).clamp_(0, w - 1)
    flat = rows[..., :, None] * w + cols[..., None, :]
    return image.reshape(lead + (h * w,)).gather(
        -1, flat.reshape(lead + (-1,))).reshape(flat.shape)


@functools.cache
def _kernel_lib():
    """Build (at first use) and load the kernel; declare its C ABI."""
    from boofcv_tpu_torch.kernels._nvcc import load_library
    lib = load_library("window_gather")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.window_gather_launch.argtypes = [vp, ctypes.c_longlong, ci, ci, vp,
                                         vp, ci, ci, ci, ci, vp, vp]
    lib.window_gather_launch.restype = ci
    lib.window_gather_error_string.argtypes = [ci]
    lib.window_gather_error_string.restype = ctypes.c_char_p
    return lib


def plane_stride(name: str, image: torch.Tensor) -> int:
    """What the kernels take as an image: float32 [h, w] or [B, h, w] whose
    [h, w] planes are contiguous.  Returns the element stride between the
    planes: h * w for a contiguous stack, 0 for one frame expanded over the
    streams (and for [h, w]).  Raises on anything else."""
    if image.dtype != torch.float32 or image.dim() not in (2, 3):
        raise ValueError(f"{name} must be [h, w] or [B, h, w] float32, got "
                         f"{tuple(image.shape)} {image.dtype}")
    if min(image.shape) < 1:
        raise ValueError(f"{name} is empty: {tuple(image.shape)}")
    if image.stride()[-2:] != (image.shape[-1], 1):
        raise ValueError(f"{name} must have contiguous [h, w] planes, got "
                         f"strides {image.stride()}")
    if image.dim() == 2 or image.shape[0] == 1:
        return 0
    if image.stride(0) not in (0, image.shape[-2] * image.shape[-1]):
        raise ValueError(f"{name} must be a contiguous stack or one frame "
                         f"expanded, got strides {image.stride()}")
    return image.stride(0)


def as_planes(image: torch.Tensor) -> torch.Tensor:
    """``image`` [h, w] or [B, h, w] as float32 in a layout
    :func:`plane_stride` takes, copied only where it must be (one frame
    expanded over the streams stays one frame)."""
    image = image.to(torch.float32)
    h, w = image.shape[-2:]
    stacked = (image.dim() == 2 or image.shape[0] == 1
               or image.stride(0) in (0, h * w))
    if stacked and image.stride()[-2:] == (w, 1):
        return image
    return image.contiguous()


def gather_windows_cuda(image: torch.Tensor, oy: torch.Tensor,
                        ox: torch.Tensor, wy: int, wx: int) -> torch.Tensor:
    """Launch the CUDA kernel, once.  image: [h, w] float32 with oy, ox: [N]
    int32, or [B, h, w] (a contiguous stack, or one frame expanded over B)
    with oy, ox: [B, N]; origins contiguous; all on one CUDA device.  Raises
    on anything else and on a failed launch."""
    global _launches
    if image.device.type != "cuda":
        raise ValueError(f"gather_windows_cuda needs CUDA tensors, got "
                         f"image on {image.device}")
    stride = plane_stride("image", image)
    want = "[B, N]" if image.dim() == 3 else "[N]"
    for name, o in (("oy", oy), ("ox", ox)):
        if o.dim() != image.dim() - 1 or o.dtype != torch.int32:
            raise ValueError(f"{name} must be {want} int32, got "
                             f"{tuple(o.shape)} {o.dtype}")
        if o.device != image.device:
            raise ValueError(f"{name} on {o.device}, image on {image.device}")
        if not o.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if oy.shape != ox.shape:
        raise ValueError(f"oy is {tuple(oy.shape)}, ox {tuple(ox.shape)}")
    if oy.shape[:-1] != image.shape[:-2]:
        raise ValueError(f"{tuple(oy.shape)} origins for "
                         f"{tuple(image.shape)} images")
    if wy <= 0 or wx <= 0:
        raise ValueError(f"window {wy}x{wx} must be positive")
    h, w = image.shape[-2:]
    out = torch.empty(tuple(oy.shape) + (wy, wx), dtype=torch.float32,
                      device=image.device)
    if oy.numel() == 0:
        return out
    lib = _kernel_lib()
    with torch.cuda.device(image.device):
        stream = torch.cuda.current_stream(image.device).cuda_stream
        err = lib.window_gather_launch(image.data_ptr(), stride, h, w,
                                       oy.data_ptr(), ox.data_ptr(),
                                       oy.numel(), oy.shape[-1], wy, wx,
                                       out.data_ptr(), stream)
    if err != 0:
        msg = lib.window_gather_error_string(err).decode()
        raise RuntimeError(f"window_gather launch failed: {msg} ({err})")
    _launches += 1
    return out


def gather_windows(image: torch.Tensor, oy: torch.Tensor, ox: torch.Tensor,
                   wy: int = 24, wx: int = 16) -> torch.Tensor:
    """[N, wy, wx] windows of ``image`` [h, w] with integer top-left corners
    (oy, ox) [N], or [B, N, wy, wx] windows of [B, h, w] images at [B, N]
    corners; reads outside the image take the nearest edge pixel.

    CPU tensors take the plain version; CUDA tensors one launch of the
    kernel, whatever B is."""
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
