"""Bundle adjustment's Schur fill-in in one CUDA kernel launch a group.

``csrc/schur_fill.cu`` subtracts from the reduced camera system S, for
every view pair, the sum of W_l^T Y_m over that pair's slot pairs, in the
order a solve fixed for them, forming each product in registers.  It
replaces no TPU kernel: the JAX package's ``_local_system`` is a one-hot
einsum that XLA fuses.

This module holds only the CUDA route.  The plain PyTorch version of the
same function is ``geo.ba._fill_in`` on a CPU tensor (``_pair_products``
and ``_segment_sum``); a CUDA tensor comes here.  A build or launch
failure raises.
"""

from __future__ import annotations

import ctypes
import struct

import torch

from boofcv_tpu_torch.kernels import _nvcc

MAX_PIECES = 128             # SCHUR_FILL_MAX_PIECES of csrc/schur_fill.cu
_INT32 = 2 ** 31


class _Args(ctypes.Structure):
    """``SchurFillArgs`` of csrc/schur_fill.cu."""
    _fields_ = [(name, ctypes.c_void_p) for name in
                ("W", "Y", "pair_perm", "pair_offsets", "runs", "S")] + [
        (name, ctypes.c_int) for name in
        ("num_runs", "num_pieces", "d", "f64")] + [
        ("pieces", ctypes.c_int * (3 * MAX_PIECES))]


# The fields before ``pieces`` are filled in one struct.pack_into a launch
# (order and sizes as above, checked against ctypes' layout at import) into
# this thread's own struct; the kernel reads ``num_pieces`` rows of
# ``pieces``, so rows left from an earlier launch are never read.
_HEAD_FMT = struct.Struct("=6Q4i")
assert _HEAD_FMT.size == _Args.pieces.offset
_KERNEL = _nvcc.Kernel("schur_fill", (_Args,))
launch_count = _KERNEL.launch_count
reset_launch_count = _KERNEL.reset_launch_count


def _check(name, x, dtype, shape, device):
    if not isinstance(x, torch.Tensor):
        raise ValueError(f"{name} must be a tensor, got {type(x).__name__}")
    if x.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {x.dtype}")
    if tuple(x.shape) != shape:
        raise ValueError(f"{name} must be {shape}, got {tuple(x.shape)}")
    if x.device != device:
        raise ValueError(f"{name} on {x.device}, S on {device}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _pack(S, W, Y, pair_perm, pair_offsets, runs, pieces) -> tuple:
    """Check the arguments of :func:`schur_fill_cuda` (on any device: the
    tensors must share S's) and fill this thread's ``SchurFillArgs`` from
    them.  Returns (S's device index, the runs R); raises ValueError on
    anything the kernel does not take."""
    if not isinstance(S, torch.Tensor) or S.dim() != 3 \
            or S.shape[1] != S.shape[2]:
        raise ValueError(f"S must be [R, D, D], got "
                         f"{tuple(getattr(S, 'shape', ()))}")
    R, D = S.shape[0], S.shape[1]
    if S.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"S must be float32 or float64, got {S.dtype}")
    if not 1 <= D <= 9:
        raise ValueError(f"D = {D}: the kernel takes 1 to 9 parameters a "
                         f"view")
    if not isinstance(W, torch.Tensor) or W.dim() != 3:
        raise ValueError(f"W must be [N, 3, {D}], got "
                         f"{tuple(getattr(W, 'shape', ()))}")
    N = W.shape[0]
    if not isinstance(pair_perm, torch.Tensor) or pair_perm.dim() != 1:
        raise ValueError("pair_perm must be a 1-D tensor")
    _check("S", S, S.dtype, (R, D, D), S.device)
    for name, x, dtype, shape in (
            ("W", W, S.dtype, (N, 3, D)), ("Y", Y, S.dtype, (N, 3, D)),
            ("pair_perm", pair_perm, torch.int64, tuple(pair_perm.shape)),
            ("pair_offsets", pair_offsets, torch.int64, (R + 1,)),
            ("runs", runs, torch.int32, (R,))):
        _check(name, x, dtype, shape, S.device)
    pairs = pair_perm.shape[0]
    if R >= _INT32 or pairs >= _INT32 or N * 3 * D >= _INT32:
        raise ValueError(f"{R} runs, {pairs} pairs, {N} slots: the kernel "
                         f"takes fewer than 2**31 runs, pairs and W "
                         f"elements")
    if not 1 <= len(pieces) <= MAX_PIECES:
        raise ValueError(f"{len(pieces)} pieces: the kernel takes 1 to "
                         f"{MAX_PIECES}")
    flat = []
    for pair0, slot0, width in pieces:
        if not (0 <= pair0 < max(pairs, 1) and 0 <= slot0 < max(N, 1)
                and width >= 1):
            raise ValueError(f"piece ({pair0}, {slot0}, {width}) lies "
                             f"outside {pairs} pairs and {N} slots")
        flat += (pair0, slot0, width)
    if any(a >= b for a, b in zip(flat[0::3], flat[3::3])):
        raise ValueError("pieces must be in increasing pair0")
    (args,), _ = _KERNEL.structs()
    _HEAD_FMT.pack_into(args, 0, W.data_ptr(), Y.data_ptr(),
                        pair_perm.data_ptr(), pair_offsets.data_ptr(),
                        runs.data_ptr(), S.data_ptr(), R, len(pieces), D,
                        int(S.dtype == torch.float64))
    args.pieces[:len(flat)] = flat
    return S.get_device(), R


def schur_fill_cuda(S, W, Y, pair_perm, pair_offsets, runs, pieces) -> None:
    """Launch the kernel, once: for each run k (a view pair) of
    ``pair_offsets`` [R + 1], S[k] -= the sum over the pair indices e of
    ``pair_perm[pair_offsets[k]:pair_offsets[k + 1]]`` (int64), in that
    order, of W[l]^T Y[m], where pair e lies in the last of ``pieces``
    (rows (pair0, slot0, width), by pair0) with pair0 <= e, e - pair0 =
    (point * width + a) * width + b and l, m = slot0 + point * width + a,
    and + b.  S [R, D, D], W and Y
    [N, 3, D]: float32 or float64 alike, contiguous, on one CUDA device;
    ``runs`` [R] int32 the runs to walk, the non-empty ones first.  S is
    written in place.  Raises on anything else and on a failed launch."""
    if not isinstance(S, torch.Tensor) or not S.is_cuda:
        raise ValueError(f"schur_fill_cuda needs CUDA tensors, got S on "
                         f"{getattr(S, 'device', type(S).__name__)}")
    idx, R = _pack(S, W, Y, pair_perm, pair_offsets, runs, pieces)
    if R > 0:
        _KERNEL.launch(idx)
