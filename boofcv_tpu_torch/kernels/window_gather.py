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
import struct

import torch

from boofcv_tpu_torch.kernels import _nvcc

_SUBLANES = 8   # row alignment of the KLT window origins (see below)


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


class _Args(ctypes.Structure):
    """``WindowGatherArgs`` of csrc/window_gather.cu."""
    _fields_ = [("img", ctypes.c_void_p), ("img_stride", ctypes.c_longlong),
                ("h", ctypes.c_int), ("w", ctypes.c_int),
                ("oy", ctypes.c_void_p), ("ox", ctypes.c_void_p),
                ("n", ctypes.c_int), ("per_image", ctypes.c_int),
                ("wy", ctypes.c_int), ("wx", ctypes.c_int),
                ("out", ctypes.c_void_p)]


# Filled in one struct.pack_into a launch (field order and sizes as above,
# checked against ctypes' layout at import) into this thread's own struct.
_ARGS_FMT = struct.Struct("=QqiiQQiiiiQ")
assert _ARGS_FMT.size == ctypes.sizeof(_Args)
_KERNEL = _nvcc.Kernel("window_gather", (_Args,))
launch_count = _KERNEL.launch_count
reset_launch_count = _KERNEL.reset_launch_count


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


def _explain(image: torch.Tensor, oy: torch.Tensor, ox: torch.Tensor,
             wy: int, wx: int) -> None:
    """Raise the ValueError that names what the fast checks of
    :func:`gather_windows_cuda` refused."""
    plane_stride("image", image)
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
    raise ValueError("gather_windows_cuda: inputs refused")  # not reached


def _gather_geometry(image: torch.Tensor, oy: torch.Tensor, ox: torch.Tensor,
                     wy: int, wx: int) -> tuple:
    """Check the arguments of :func:`gather_windows_cuda` (on any device:
    the origins must share the image's).  Returns (the image's device
    index, (plane stride, h, w, windows an image), the output's shape);
    raises ValueError on anything the kernel does not take."""
    # fast checks, one pass; anything refused is explained by _explain
    try:
        ish = image.shape
        st = image.stride()
        nd = len(ish)
        h, w = ish[-2:]
        stride = 0 if nd == 2 or ish[0] == 1 else st[0]
        osh = oy.shape
        idx = image.get_device()
        ok = (image.dtype is torch.float32 and (nd == 2 or nd == 3)
              and ish.numel() > 0 and st[-1] == 1 and st[-2] == w
              and (stride == 0 or stride == h * w)
              and oy.dtype is torch.int32 and ox.dtype is torch.int32
              and len(osh) == nd - 1 and ox.shape == osh
              and osh[:-1] == ish[:-2] and oy.get_device() == idx
              and ox.get_device() == idx and oy.is_contiguous()
              and ox.is_contiguous() and wy > 0 and wx > 0)
    except (AttributeError, TypeError, ValueError):
        ok = False
    if not ok:
        _explain(image, oy, ox, wy, wx)
    return idx, (stride, h, w, osh[-1]), tuple(osh) + (wy, wx)


def gather_windows_cuda(image: torch.Tensor, oy: torch.Tensor,
                        ox: torch.Tensor, wy: int, wx: int) -> torch.Tensor:
    """Launch the CUDA kernel, once.  image: [h, w] float32 with oy, ox: [N]
    int32, or [B, h, w] (a contiguous stack, or one frame expanded over B)
    with oy, ox: [B, N]; origins contiguous; all on one CUDA device.  Raises
    on anything else and on a failed launch."""
    if not image.is_cuda:
        raise ValueError(f"gather_windows_cuda needs CUDA tensors, got "
                         f"image on {image.device}")
    idx, geometry, shape = _gather_geometry(image, oy, ox, wy, wx)
    out = torch.empty(shape, dtype=torch.float32, device=image.device)
    n = oy.numel()
    if n == 0:
        return out
    stride, h, w, per_image = geometry
    (args,), _ = _KERNEL.structs()
    _ARGS_FMT.pack_into(args, 0, image.data_ptr(), stride, h, w,
                        oy.data_ptr(), ox.data_ptr(), n, per_image, wy, wx,
                        out.data_ptr())
    _KERNEL.launch(idx)
    return out


def launch_empty(n: int, wy: int, wx: int, device) -> None:
    """Launch a kernel that returns at once on the grid and block that
    ``n`` windows of wy x wx get: what one such launch costs the device
    whatever it reads.  A measurement probe; it is not counted as a launch
    of the gather."""
    fn = _KERNEL.library().window_gather_empty_launch
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = _nvcc.call_on_device(
        torch.cuda._get_device_index(device, optional=True), fn, n, wy, wx)
    if err:
        _KERNEL.fail(err, "empty launch")


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
