"""Device meshes and the collectives over them (port of
``boofcv_tpu/dist/mesh.py``).

The reference is SPMD inside one process: a ``jax.sharding.Mesh`` of
devices, ``shard_map`` and ``psum`` / ``psum_scatter`` / ``all_gather``.
The port runs one process a rank: every rank calls the same function with
the same full (replicated) inputs, cuts its own shard by its place in the
mesh, and meets the others in ``torch.distributed`` collectives over the
groups of a ``DeviceMesh``.  ``psum`` is :func:`all_reduce`, a tiled
``psum_scatter`` is :func:`reduce_scatter`, a tiled ``all_gather`` is
:func:`all_gather`; every rank returns the whole answer.

The backend follows the device: NCCL for CUDA (each rank on
``cuda:{local rank}``), gloo for the CPU.  A CUDA mesh whose NCCL group
fails to start raises; nothing moves to gloo or to the CPU.
"""

from __future__ import annotations

import os
import warnings

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from boofcv_tpu_torch._config import resolve_device

SHARD_AXIS = "shard"

_BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def _backend(dev: torch.device) -> str:
    if dev.type not in _BACKENDS:
        raise ValueError(f"no collective backend for device {dev}")
    return _BACKENDS[dev.type]


def _init_kwargs(dev: torch.device, local_device=None) -> dict:
    """The device arguments of ``init_process_group``: a CUDA rank is bound
    to its card, and ``device_id`` starts its NCCL communicator at once, so
    a failed start raises here and not at the first collective."""
    if dev.type != "cuda":
        return {}
    index = dev.index if local_device is None else int(local_device)
    if index is None:
        index = torch.cuda.current_device()
    torch.cuda.set_device(index)
    return {"device_id": torch.device("cuda", index)}


def _default_group(dev: torch.device) -> None:
    """Check that the running default group's backend suits ``dev``, or
    start one: a torchrun rank (its ``MASTER_ADDR``, ``MASTER_PORT``,
    ``WORLD_SIZE`` and ``RANK`` set) joins its job's group, any other
    process gets a one-rank group in memory."""
    backend = _backend(dev)
    if dist.is_initialized():
        running = dist.get_backend()
        if running != backend:
            raise RuntimeError(f"the default process group runs {running}; "
                               f"a {dev.type} mesh needs {backend}")
        return
    if backend == "nccl" and not dist.is_nccl_available():
        raise RuntimeError("a CUDA mesh needs NCCL, and this torch has none")
    if all(k in os.environ for k in ("MASTER_ADDR", "MASTER_PORT",
                                     "WORLD_SIZE", "RANK")):
        initialize_multihost(device=dev)
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1, **_init_kwargs(dev))


def device_count() -> int:
    """The ranks of the default process group (1 before one is started:
    :func:`make_mesh` then starts a one-rank group)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def make_mesh(n_devices: int | None = None, axis: str = SHARD_AXIS,
              device=None) -> DeviceMesh:
    """1-D mesh over every rank of the default group.

    With no group started, a rank of a torchrun job joins the job's group
    (:func:`initialize_multihost`), and any other process gets a one-rank
    group, started here in memory (no address, no port): gloo for the CPU,
    NCCL for the card.
    ``device`` None means the card (raises without one).  ``n_devices``,
    where given, must be the group's size: a process holds one rank, so a
    mesh over part of the group would leave ranks out of the collectives.
    """
    dev = resolve_device(device)
    _default_group(dev)
    n = dist.get_world_size()
    if n_devices is not None and n_devices != n:
        raise ValueError(f"a mesh spans the default group's {n} ranks, "
                         f"not {n_devices}: start the group with "
                         f"{n_devices} processes")
    return init_device_mesh(dev.type, (n,), mesh_dim_names=(axis,))


def initialize_multihost(coordinator_address: str | None = None,
                         num_processes: int | None = None,
                         process_id: int | None = None,
                         local_device_ids=None, device=None) -> None:
    """Multi-process initialization: ``init_process_group`` over TCP.

    Every process calls this before any mesh is made.  Arguments default
    to torchrun's environment: ``MASTER_ADDR:MASTER_PORT`` for the
    coordinator, ``WORLD_SIZE``, ``RANK``, and ``LOCAL_RANK`` for the card
    this rank drives (``local_device_ids``, one index).  ``device`` None
    means the card and NCCL; ``"cpu"`` means gloo.
    """
    env = os.environ
    addr = coordinator_address or f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    world = int(num_processes if num_processes is not None
                else env["WORLD_SIZE"])
    rank = int(process_id if process_id is not None else env["RANK"])
    dev = resolve_device(device)
    local = (local_device_ids if local_device_ids is not None
             else env.get("LOCAL_RANK", 0))
    dist.init_process_group(_backend(dev), init_method=f"tcp://{addr}",
                            world_size=world, rank=rank,
                            **_init_kwargs(dev, local))


def make_mesh_2d(n_hosts: int | None = None,
                 devices_per_host: int | None = None,
                 host_axis: str = "host", axis: str = SHARD_AXIS,
                 device=None) -> DeviceMesh:
    """2-D (host, shard) mesh: rows are hosts, columns each host's ranks.

    ``n_hosts`` defaults to the group's size over torchrun's
    ``LOCAL_WORLD_SIZE`` (1 without it).  A collective over both axes is
    reduced within each host row first, then across the rows."""
    dev = resolve_device(device)
    _default_group(dev)
    n = dist.get_world_size()
    if n_hosts is None:
        n_hosts = max(n // int(os.environ.get("LOCAL_WORLD_SIZE", n)), 1)
    if devices_per_host is None:
        devices_per_host = n // n_hosts
    if n_hosts * devices_per_host != n:
        raise ValueError(f"{n_hosts} x {devices_per_host} is not the "
                         f"default group's {n} ranks")
    return init_device_mesh(dev.type, (n_hosts, devices_per_host),
                            mesh_dim_names=(host_axis, axis))


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """This rank's device in ``mesh``."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def check_device(mesh: DeviceMesh, dev: torch.device) -> None:
    """Raise unless tensors on ``dev`` can go through ``mesh``'s
    collectives."""
    if torch.device(dev).type != mesh.device_type:
        raise ValueError(f"tensors on {dev} cannot go through a "
                         f"{mesh.device_type} mesh")


def shard_index(mesh: DeviceMesh) -> tuple:
    """(this rank's place in the mesh's row-major order, the mesh's size):
    shard ``i`` of ``n`` of a tensor split on its leading axis."""
    ranks = mesh.mesh.flatten().tolist()
    return ranks.index(dist.get_rank()), len(ranks)


def all_reduce(x: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """The sum of ``x`` over every rank of ``mesh`` (``psum`` over all its
    axes), in place: the inner axis first."""
    for name in reversed(mesh.mesh_dim_names):
        dist.all_reduce(x, group=mesh.get_group(name))
    return x


def all_gather(x: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """Every rank's ``x`` concatenated on the leading axis in the mesh's
    row-major order (a tiled ``all_gather`` over all its axes).  Booleans
    travel as uint8."""
    if x.dtype == torch.bool:
        return all_gather(x.to(torch.uint8), mesh).bool()
    x = x.contiguous()
    for name in reversed(mesh.mesh_dim_names):
        group = mesh.get_group(name)
        out = x.new_empty((group.size() * x.shape[0],) + x.shape[1:])
        with warnings.catch_warnings():
            # deprecated in newer torch for all_gather_single, which the
            # card's torch does not have
            warnings.simplefilter("ignore", FutureWarning)
            dist.all_gather_into_tensor(out, x, group=group)
        x = out
    return x


def reduce_scatter(x: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """Rows ``[i * m, (i + 1) * m)`` of the sum of ``x`` [n * m, ...] over
    the ranks of a 1-D ``mesh`` (a tiled ``psum_scatter`` on the leading
    axis), ``i`` this rank's place."""
    if mesh.ndim != 1:
        raise ValueError("reduce_scatter takes a 1-D mesh")
    group = mesh.get_group()
    x = x.contiguous()
    out = x.new_empty((x.shape[0] // group.size(),) + x.shape[1:])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        dist.reduce_scatter_tensor(out, x, group=group)
    return out
