"""Meshes and placements for sample and field parallelism (counterpart of
``nifty_tpu/parallel/mesh.py``).

A mesh is a ``torch.distributed`` ``DeviceMesh`` over ranks, one card (or
CPU process) a rank.  The JAX package's ``NamedSharding`` becomes
:class:`NamedSharding`, a record of the mesh and a spec: per array axis
the mesh axis it is split over, or None.  A tensor in the port is always
the rank's own shard (rows ``[r n/p, (r + 1) n/p)`` of a split axis);
:meth:`NamedSharding.shard` cuts it from the full array and
:func:`gather_axis` joins the shards of a group.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch
import torch.distributed as dist

from .multihost import backend_device, process_count

__all__ = ["NamedSharding", "replicated_sharding", "sample_mesh", "sample_sharding"]


class NamedSharding(NamedTuple):
    """A placement on ``mesh``: ``spec[i]`` names the mesh axis that array
    axis ``i`` is split over (None, or absent: not split)."""

    mesh: object
    spec: tuple = ()

    @property
    def placements(self):
        """The ``DTensor`` placements of the spec, one a mesh axis:
        ``Shard(i)`` where array axis ``i`` names it, else ``Replicate()``."""
        from torch.distributed.tensor import Replicate, Shard

        return tuple(
            next((Shard(i) for i, a in enumerate(self.spec) if a == name), Replicate())
            for name in self.mesh.mesh_dim_names
        )

    def split_axes(self):
        """``(array axis, mesh axis name)`` of every split axis."""
        return [(i, a) for i, a in enumerate(self.spec) if a is not None]

    def shard(self, x):
        """This rank's shard of the full array ``x``."""
        for i, name in self.split_axes():
            p, r = self.mesh.size(_dim(self.mesh, name)), self.mesh.get_local_rank(name)
            if x.shape[i] % p:
                raise ValueError(f"axis {i} of {tuple(x.shape)} does not split over {p} ranks")
            b = x.shape[i] // p
            x = x.narrow(i, r * b, b)
        return x.contiguous()


def _dim(mesh, name) -> int:
    return mesh.mesh_dim_names.index(name)


def gather_axis(x, axis: int, group, uneven: bool = False, sizes=None):
    """The shards ``x`` of the ranks of ``group`` joined along ``axis`` in
    rank order: every shard of the same shape, or with ``uneven`` shards of
    any length along ``axis`` (their lengths gathered first, or given as
    ``sizes``; the shards padded to the longest and cropped)."""
    p = dist.get_world_size(group)
    dev = backend_device()
    src = x.movedim(axis, 0).contiguous()
    real = torch.view_as_real(src) if src.is_complex() else src
    if sizes is None and uneven:
        mine = torch.tensor([src.shape[0]], dtype=torch.int64, device=dev)
        every = [torch.empty_like(mine) for _ in range(p)]
        dist.all_gather(every, mine, group=group)
        sizes = torch.cat(every).tolist()
    sizes = [src.shape[0]] * p if sizes is None else [int(n) for n in sizes]
    if max(sizes) > src.shape[0]:
        real = torch.cat([real, real.new_zeros((max(sizes) - src.shape[0],) + tuple(real.shape[1:]))])
    parts = [torch.empty_like(real, device=dev) for _ in range(p)]
    dist.all_gather(parts, real.to(dev), group=group)
    out = torch.cat([part[:n] for part, n in zip(parts, sizes)]).to(x.device)
    if src.is_complex():
        out = torch.view_as_complex(out)
    return out.movedim(0, axis)


def sample_mesh(devices: Optional[Sequence[int]] = None, axis_name: str = "samples"):
    """A 1-D mesh over the ranks ``devices`` (default: every rank of the
    default group)."""
    from torch.distributed.device_mesh import DeviceMesh

    ranks = list(range(process_count())) if devices is None else [int(d) for d in devices]
    return DeviceMesh(backend_device().type, torch.tensor(ranks), mesh_dim_names=(axis_name,))


def sample_sharding(mesh, axis_name: str = "samples") -> NamedSharding:
    """Split the leading (sample) axis over the mesh."""
    return NamedSharding(mesh, (axis_name,))


def replicated_sharding(mesh) -> NamedSharding:
    """The whole array on every rank of the mesh."""
    return NamedSharding(mesh, ())
