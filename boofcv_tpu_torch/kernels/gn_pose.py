"""Gauss-Newton pose refinement of B problems in one CUDA kernel launch.

``csrc/gn_pose.cu`` runs the float32 Gauss-Newton loop of
``geo/pnp.gauss_newton_pose`` and the two float64 Newton-polar steps after
it, one thread block per problem, every iteration inside the launch.  It
replaces no TPU kernel: the JAX package's loop is a ``lax.while_loop`` that
XLA fuses, where the port's eager loop launched about 110 kernels an
iteration.

This module holds only the CUDA route.  The plain PyTorch version of the
same function is ``geo.pnp._gn_pose_f32``; ``geo.pnp.gauss_newton_pose``
sends CPU tensors there and CUDA tensors here.  A build or launch failure
raises.
"""

from __future__ import annotations

import ctypes
import struct

import torch

from boofcv_tpu_torch.kernels import _nvcc


class _Args(ctypes.Structure):
    """``GnPoseArgs`` of csrc/gn_pose.cu."""
    _fields_ = [(name, ctypes.c_void_p) for name in
                ("R", "t", "world", "obs", "wgt", "R_out", "t_out")] + [
        ("b", ctypes.c_int), ("n", ctypes.c_int),
        ("iterations", ctypes.c_int), ("damping", ctypes.c_float),
        ("step_tol", ctypes.c_float)] + [
        (name, ctypes.c_int) for name in
        ("R_f64", "t_f64", "world_f64", "obs_f64", "wgt_f64")]


# Filled in one struct.pack_into a launch (field order and sizes as above,
# checked against ctypes' layout at import) into this thread's own struct.
_ARGS_FMT = struct.Struct("=7Q3i2f5i")
assert _ARGS_FMT.size == ctypes.sizeof(_Args)
_KERNEL = _nvcc.Kernel("gn_pose", (_Args,))
launch_count = _KERNEL.launch_count
reset_launch_count = _KERNEL.reset_launch_count
_F32, _F64 = torch.float32, torch.float64
_NAMES = ("R", "t", "world", "obs", "weights")


def _explain(tensors) -> None:
    """Raise the ValueError that names what the fast checks of
    :func:`_pack` refused."""
    for name, x in zip(_NAMES, tensors):
        if not isinstance(x, torch.Tensor):
            raise ValueError(f"{name} must be a tensor, got "
                             f"{type(x).__name__}")
    R, t, world, obs, weights = tensors
    if world.dim() < 2 or world.shape[-1] != 3:
        raise ValueError(f"world must be [..., N, 3], got "
                         f"{tuple(world.shape)}")
    lead, n = tuple(world.shape[:-2]), world.shape[-2]
    want = {"R": lead + (3, 3), "t": lead + (3,), "world": lead + (n, 3),
            "obs": lead + (n, 2), "weights": lead + (n,)}
    for name, x in zip(_NAMES, tensors):
        if x.dtype not in (_F32, _F64):
            raise ValueError(f"{name} must be float32 or float64, got "
                             f"{x.dtype}")
        if x.device != world.device:
            raise ValueError(f"{name} on {x.device}, world on "
                             f"{world.device}")
        if tuple(x.shape) != want[name]:
            raise ValueError(f"{name} must be {want[name]} for world "
                             f"{tuple(world.shape)}, got {tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if n >= 2 ** 31:
        raise ValueError(f"{n} points: the kernel takes fewer than 2**31")
    raise ValueError("gn_pose_cuda: inputs refused")  # not reached


def _pack(R, t, world, obs, weights, iterations: int, damping: float,
          step_tol: float) -> tuple:
    """Check the arguments of :func:`gn_pose_cuda` (on any device: the
    tensors must share ``world``'s) and fill this thread's ``GnPoseArgs``
    from them, output pointers 0.  Returns (world's
    device index, the leading shape, problems in all); raises ValueError
    on anything the kernel does not take."""
    if iterations < 0:
        raise ValueError(f"iterations {iterations} is negative")
    tensors = (R, t, world, obs, weights)
    # fast checks, one pass; anything refused is explained by _explain
    try:
        wsh = world.shape
        lead, n = wsh[:-2], wsh[-2]
        idx = world.get_device()
        ok = (len(wsh) >= 2 and wsh[-1] == 3 and n < 2 ** 31
              and R.shape == lead + (3, 3) and t.shape == lead + (3,)
              and obs.shape == lead + (n, 2)
              and weights.shape == lead + (n,))
        flags = []
        for x in tensors:
            dt = x.dtype
            ok = (ok and (dt is _F32 or dt is _F64)
                  and x.get_device() == idx and x.is_contiguous())
            flags.append(int(dt is _F64))
    except (AttributeError, IndexError, TypeError, ValueError):
        ok = False
    if not ok:
        _explain(tensors)
    b = lead.numel()
    (args,), _ = _KERNEL.structs()
    _ARGS_FMT.pack_into(args, 0, R.data_ptr(), t.data_ptr(),
                        world.data_ptr(), obs.data_ptr(), weights.data_ptr(),
                        0, 0, b, n, iterations, damping, step_tol, *flags)
    return idx, lead, b


def gn_pose_cuda(R, t, world, obs, weights, iterations: int, damping: float,
                 step_tol: float):
    """Launch the kernel, once.  R [..., 3, 3], t [..., 3], world
    [..., N, 3], obs [..., N, 2] (normalized coords), weights [..., N]:
    float32 or float64 each, contiguous, on one CUDA device, every leading
    shape world's.  Runs ``iterations`` float32 Gauss-Newton steps
    (``damping`` on H's diagonal; a problem stops after its first step with
    max|dx| <= ``step_tol``), then two float64 Newton-polar steps on R.
    Raises on anything else and on a failed launch.

    Returns (R [..., 3, 3], t [..., 3]) in float64."""
    if not isinstance(world, torch.Tensor) or not world.is_cuda:
        raise ValueError(f"gn_pose_cuda needs CUDA tensors, got world on "
                         f"{getattr(world, 'device', type(world).__name__)}")
    idx, lead, b = _pack(R, t, world, obs, weights, iterations, damping,
                         step_tol)
    # one allocation for both outputs: R, then t
    out = torch.empty(12 * b, dtype=_F64, device=world.device)
    R_out = out[:9 * b].view(lead + (3, 3))
    t_out = out[9 * b:].view(lead + (3,))
    if b > 0:
        (args,), _ = _KERNEL.structs()
        base = out.data_ptr()
        args.R_out = base
        args.t_out = base + 72 * b
        _KERNEL.launch(idx)
    return R_out, t_out
