"""The P3P RANSAC bank of ``geo/robust.ransac_pnp`` in one CUDA kernel
launch.

``csrc/pnp_bank.cu`` solves Grunert's P3P for every index set of B
streams' banks, scores each sample's four solutions against every point of
its stream (inlier count and MSAC sum), picks each stream's winner with the
float64 tie-break of ``geo/robust.ransac`` and writes the winner's pose and
inlier mask.  It replaces no TPU kernel: the JAX package's bank is a few
batched ops that XLA fuses, where the port's eager route launched about 390
kernels a call.

This module holds only the CUDA route.  The plain PyTorch version of the
same function is ``geo.robust.ransac`` with ``pnp.p3p_grunert`` and
``pnp.reprojection_error_sq`` (``robust._plain_bank``);
``geo.robust.ransac_pnp`` sends CPU tensors there and CUDA tensors here.
A build or launch failure raises.
"""

from __future__ import annotations

import ctypes
import struct

import torch

from boofcv_tpu_torch.kernels import _nvcc

SOL_WORDS = 16               # kSolWords of csrc/pnp_bank.cu
MAX_STREAMS = 65535          # the grid's second dimension
_INT32 = 2 ** 31


class _Args(ctypes.Structure):
    """``PnpBankArgs`` of csrc/pnp_bank.cu."""
    _fields_ = [(name, ctypes.c_void_p) for name in
                ("world", "obs", "idx", "valid", "sol", "tickets", "R_out",
                 "t_out", "err_out", "count_out", "ok_out",
                 "inliers_out")] + [
        ("b", ctypes.c_int), ("n", ctypes.c_int), ("k", ctypes.c_int),
        ("thr", ctypes.c_float), ("world_f64", ctypes.c_int),
        ("obs_f64", ctypes.c_int)]


# Filled in one struct.pack_into a launch (field order and sizes as above,
# checked against ctypes' layout at import) into this thread's own struct.
_ARGS_FMT = struct.Struct("=12Q3if2i")
assert _ARGS_FMT.size == ctypes.sizeof(_Args)
# -fmad=false: no product and sum contracted into an FMA, as the eager
# route's separate ops round them
_KERNEL = _nvcc.Kernel("pnp_bank", (_Args,), flags=("-fmad=false",))
launch_count = _KERNEL.launch_count
reset_launch_count = _KERNEL.reset_launch_count
_F32, _F64 = torch.float32, torch.float64
# (device index, stream) -> int32 tickets, zero between launches (each
# launch returns them to zero); a stream's launches run in its order
_tickets: dict = {}


def _explain(world, obs, idx, valid_mask) -> None:
    """Raise the ValueError that names what the fast checks of
    :func:`_pack` refused."""
    named = (("world", world), ("obs", obs), ("idx", idx),
             ("valid_mask", valid_mask))
    for name, x in named:
        if not isinstance(x, torch.Tensor) and not (
                name == "valid_mask" and x is None):
            raise ValueError(f"{name} must be a tensor, got "
                             f"{type(x).__name__}")
    if world.dim() not in (2, 3) or world.shape[-1] != 3:
        raise ValueError(f"world must be [N, 3] or [B, N, 3], got "
                         f"{tuple(world.shape)}")
    lead, n = tuple(world.shape[:-2]), world.shape[-2]
    k = idx.shape[-2] if idx.dim() >= 2 else -1
    want = {"world": (lead + (n, 3), (_F32, _F64)),
            "obs": (lead + (n, 2), (_F32, _F64)),
            "idx": (lead + (k, 3), (torch.int64,)),
            "valid_mask": (lead + (n,), (torch.bool,))}
    for name, x in named:
        if x is None:
            continue
        shape, dtypes = want[name]
        if x.dtype not in dtypes:
            raise ValueError(f"{name} must be "
                             f"{' or '.join(map(str, dtypes))}, got "
                             f"{x.dtype}")
        if x.device != world.device:
            raise ValueError(f"{name} on {x.device}, world on "
                             f"{world.device}")
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} must be {shape} for world "
                             f"{tuple(world.shape)}, got {tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    b = lead[0] if lead else 1
    if n < 1 or k < 1:
        raise ValueError(f"{n} points and {k} samples: the kernel takes at "
                         f"least one of each")
    if b > MAX_STREAMS or n >= _INT32 or 4 * SOL_WORDS * k >= _INT32:
        raise ValueError(f"{b} streams, {n} points, {k} samples: the kernel "
                         f"takes at most {MAX_STREAMS} streams and fewer "
                         f"than 2**31 points and 2**25 samples")
    raise ValueError("pnp_bank_cuda: inputs refused")  # not reached


def _pack(world, obs, idx, valid_mask, inlier_threshold: float) -> tuple:
    """Check the arguments of :func:`pnp_bank_cuda` (on any device: the
    tensors must share ``world``'s) and fill this thread's
    ``PnpBankArgs`` from them, output and scratch pointers 0.  Returns
    (world's device index, the leading shape, streams B, points N,
    samples K); raises ValueError on anything the kernel does not take."""
    try:
        wsh = world.shape
        lead, n = wsh[:-2], wsh[-2]
        k = idx.shape[-2]
        dev = world.device
        b = lead[0] if lead else 1
        ok = (len(wsh) in (2, 3) and wsh[-1] == 3
              and obs.shape == lead + (n, 2) and idx.shape == lead + (k, 3)
              and idx.dtype is torch.int64 and 1 <= n < _INT32
              and 1 <= k and 4 * SOL_WORDS * k < _INT32
              and b <= MAX_STREAMS
              and world.dtype in (_F32, _F64) and obs.dtype in (_F32, _F64)
              and obs.device == dev and idx.device == dev
              and world.is_contiguous() and obs.is_contiguous()
              and idx.is_contiguous())
        if valid_mask is not None:
            ok = (ok and valid_mask.shape == lead + (n,)
                  and valid_mask.dtype is torch.bool
                  and valid_mask.device == dev
                  and valid_mask.is_contiguous())
    except (AttributeError, IndexError, TypeError, ValueError):
        ok = False
    if not ok:
        _explain(world, obs, idx, valid_mask)
    (args,), _ = _KERNEL.structs()
    _ARGS_FMT.pack_into(
        args, 0, world.data_ptr(), obs.data_ptr(), idx.data_ptr(),
        0 if valid_mask is None else valid_mask.data_ptr(),
        0, 0, 0, 0, 0, 0, 0, 0, b, n, k, float(inlier_threshold),
        int(world.dtype is _F64), int(obs.dtype is _F64))
    return world.get_device(), lead, b, n, k


def check_indices(idx, n: int) -> None:
    """Raise ValueError unless every index of ``idx`` lies in [0, n), as
    the plain route's indexing demands.  For index sets on the host: on
    the card it would read two numbers back (a host sync), and the kernel
    makes a sample with an index outside unusable instead."""
    if idx.numel() == 0:
        return
    lo, hi = (int(v) for v in torch.aminmax(idx))
    if lo < 0 or hi >= n:
        raise ValueError(f"idx holds indices in [{lo}, {hi}], outside "
                         f"[0, {n}) for {n} points")


def _stream_tickets(index: int, b: int) -> torch.Tensor:
    """The zeroed tickets of device ``index``'s current stream, at least
    ``b`` of them."""
    key = (index, _nvcc._raw_stream(index))
    t = _tickets.get(key)
    if t is None or t.numel() < b:
        t = _tickets[key] = torch.zeros(
            max(b, 16), dtype=torch.int32,
            device=torch.device("cuda", index))
    return t


def pnp_bank_cuda(world, obs, idx, valid_mask, inlier_threshold: float):
    """Launch the kernel, once.  world [..., N, 3] and obs [..., N, 2]
    (normalized coords), float32 or float64 each; idx [..., K, 3] int64,
    each index in [0, N) (an index outside makes its sample unusable);
    valid_mask [..., N] bool or None; one stream or B with a leading axis
    on every argument, contiguous, on one CUDA device.  Raises on anything
    else and on a failed launch.

    Returns (R [..., 3, 3], t [..., 3] float32, ok [...] bool), inliers
    [..., N] bool, num_inliers [...] int64, best_error [...] float32: the
    winner of each stream's bank, as ``robust.ransac`` returns it."""
    if not isinstance(world, torch.Tensor) or not world.is_cuda:
        raise ValueError(f"pnp_bank_cuda needs CUDA tensors, got world on "
                         f"{getattr(world, 'device', type(world).__name__)}")
    index, lead, b, n, k = _pack(world, obs, idx, valid_mask,
                                 inlier_threshold)
    dev = world.device
    # one float32 allocation for R, t, the MSAC and the scratch; one bool
    # for the masks and ok
    f32 = torch.empty(13 * b + 4 * SOL_WORDS * k * b, dtype=_F32,
                      device=dev)
    flags = torch.empty(b * n + b, dtype=torch.bool, device=dev)
    count = torch.empty(lead, dtype=torch.int64, device=dev)
    (args,), _ = _KERNEL.structs()
    base = f32.data_ptr()
    args.R_out, args.t_out = base, base + 36 * b
    args.err_out, args.sol = base + 48 * b, base + 52 * b
    args.tickets = _stream_tickets(index, b).data_ptr()
    args.count_out = count.data_ptr()
    args.inliers_out = flags.data_ptr()
    args.ok_out = args.inliers_out + b * n
    _KERNEL.launch(index)
    R = f32[:9 * b].view(lead + (3, 3))
    t = f32[9 * b:12 * b].view(lead + (3,))
    err = f32[12 * b:13 * b].view(lead)
    inliers = flags[:b * n].view(lead + (n,))
    ok = flags[b * n:].view(lead)
    return (R, t, ok), inliers, count, err
