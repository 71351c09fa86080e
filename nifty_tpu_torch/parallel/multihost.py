"""Multi-process execution: the process group, its size and rank, global
meshes and the host-local share of a range (counterpart of
``nifty_tpu/parallel/multihost.py``).

One process drives one card.  :func:`initialize` forms the default
``torch.distributed`` group: NCCL for the card, gloo when the caller asks
for the CPU (``device="cpu"``).  A run of one process forms a group of one
rank too, so the single-card path is the multi-card one with ``p = 1``
(the JAX package's ``initialize`` does nothing for one process: JAX sees
its devices without a group, torch does not).
"""

from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from .. import device as _device

__all__ = [
    "backend_device",
    "global_mesh",
    "host_local_slice",
    "initialize",
    "process_count",
    "process_index",
]


def _init_method(coordinator_address):
    """``env://`` without an address, a ``file://`` store for a path (or a
    ``file://`` URL), else ``tcp://`` at ``host:port``."""
    if coordinator_address is None:
        return "env://"
    addr = str(coordinator_address)
    if addr.startswith(("file://", "tcp://", "env://")):
        return addr
    if addr.startswith(os.sep):
        return f"file://{addr}"
    return f"tcp://{addr}"


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    device=None,
):
    """Form the default process group (nothing if one exists): NCCL on the
    card (the card of index ``process_id`` modulo the cards present),
    gloo for ``device="cpu"``; without a card and without
    ``device="cpu"`` it raises.  ``coordinator_address`` is ``host:port``
    (``tcp://``), a file path (a ``file://`` store, which needs no free
    port), or None (``env://``: ``MASTER_ADDR``, ``MASTER_PORT``,
    ``WORLD_SIZE``, ``RANK``).  One process still forms a group of one."""
    if dist.is_initialized():
        return
    dev = _device.resolve(device)
    method = _init_method(coordinator_address)
    if method != "env://":
        num_processes = 1 if num_processes is None else int(num_processes)
        process_id = 0 if process_id is None else int(process_id)
    kw = {} if method == "env://" else dict(world_size=num_processes, rank=process_id)
    if dev.type == "cuda":
        rank = process_id if process_id is not None else int(os.environ.get("RANK", "0"))
        torch.cuda.set_device(rank % torch.cuda.device_count())
        dist.init_process_group("nccl", init_method=method, **kw)
    else:
        dist.init_process_group("gloo", init_method=method, **kw)


def backend_device() -> torch.device:
    """The device the default group's collectives take tensors on: the
    current card under NCCL, the CPU under gloo."""
    if dist.is_initialized() and dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def process_count() -> int:
    """The ranks of the default group (1 without one)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    """This process's rank in the default group (0 without one)."""
    return dist.get_rank() if dist.is_initialized() else 0


def global_mesh(axis_names: Sequence[str] = ("samples",), axis_sizes: Optional[Sequence[int]] = None):
    """A ``DeviceMesh`` over every rank of the default group.

    With one axis all ranks line up on it.  With several, ``axis_sizes``
    splits the rank count; by default, as in the JAX package, the first
    axis gets ``process_count()`` and the last the devices of a process
    (one: a process drives one card), the axes between 1."""
    from torch.distributed.device_mesh import init_device_mesh

    n = process_count()
    if axis_sizes is None:
        if len(axis_names) == 1:
            axis_sizes = (n,)
        else:
            first = process_count()
            axis_sizes = (first,) + (1,) * (len(axis_names) - 2) + (n // first,)
    axis_sizes = tuple(int(s) for s in axis_sizes)
    if int(torch.tensor(axis_sizes).prod()) != n:
        raise ValueError(f"axis sizes {axis_sizes} do not factor the rank count {n}")
    return init_device_mesh(backend_device().type, axis_sizes, mesh_dim_names=tuple(axis_names))


def host_local_slice(n_items: int, *, count=None, index=None) -> Tuple[int, int]:
    """The contiguous ``[lo, hi)`` of ``n_items`` this process owns (the
    reference's ``shareRange``): the first ``n_items % count`` processes
    take one more."""
    count = process_count() if count is None else count
    index = process_index() if index is None else index
    base, extra = divmod(n_items, count)
    lo = index * base + min(index, extra)
    hi = lo + base + (1 if index < extra else 0)
    return lo, hi
