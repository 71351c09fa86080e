"""The collectives of sharded execution: differentiable sums over a group,
the all-to-all exchange, and the field context the tree algebra reads.

A field-sharded run keeps on each rank the rows of the excitation field
and of the data it holds, and every other leaf of the position whole
(replicated).  Two linear maps, each the other's adjoint, make the
reductions exact under ``torch.func`` (grad, jvp, vmap; forward over
reverse):

- :func:`reduce_sum`, the sum over the ranks of a group: the energies'
  sums over data rows, the tree algebra's inner products over field rows.
  Its adjoint hands each rank the cotangent (the sum is replicated);
- :func:`replicate`, the identity on a replicated value that enters
  rank-local work (the amplitude's parameters before they colour the
  rank's rows): its adjoint is the sum of the ranks' partial cotangents.

:func:`field_sharded` names, while it is active, the group and the
position keys whose leaves are row shards: :func:`~..utils.tree.vdot`,
``dot``, ``norm``, ``sample_vdot`` and ``sample_norm`` sum those leaves'
terms over the group, the likelihoods' energies sum their data over it
(the data are the field's rows), and the white noise of a sample draws
the full array and keeps the rank's rows, so a sharded run draws the
samples of the one-process run.  Collectives take CUDA tensors under
NCCL and CPU tensors under gloo; the data go where the group needs them.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple, Optional

import torch
import torch.distributed as dist

from .multihost import backend_device

__all__ = [
    "FieldShards",
    "all_to_all",
    "field",
    "field_sharded",
    "reduce_sum",
    "replicate",
]


def _all_reduce(x, group, op=dist.ReduceOp.SUM):
    """``x`` reduced by ``op`` (the sum) over ``group``, on ``x``'s device
    and in its dtype."""
    dev = backend_device()
    buf = x.detach().to(dev, copy=True).contiguous()
    real = torch.view_as_real(buf) if buf.is_complex() else buf
    dist.all_reduce(real, op=op, group=group)
    return buf.to(x.device)


class _Reduce(torch.autograd.Function):
    """Σ over the ranks of ``group``; the adjoint of :class:`_Replicate`."""

    @staticmethod
    def forward(x, group):
        return _all_reduce(x, group)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.group = inputs[1]

    @staticmethod
    def backward(ctx, grad):
        return _Replicate.apply(grad, ctx.group), None

    @staticmethod
    def jvp(ctx, tangent, _):
        return _Reduce.apply(tangent, ctx.group)

    @staticmethod
    def vmap(info, in_dims, x, group):
        return _Reduce.apply(x, group), in_dims[0]


class _Replicate(torch.autograd.Function):
    """The identity on a replicated value; its adjoint sums the ranks'
    cotangents (:class:`_Reduce`)."""

    @staticmethod
    def forward(x, group):
        return x.clone()

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.group = inputs[1]

    @staticmethod
    def backward(ctx, grad):
        return _Reduce.apply(grad, ctx.group), None

    @staticmethod
    def jvp(ctx, tangent, _):
        return _Replicate.apply(tangent, ctx.group)

    @staticmethod
    def vmap(info, in_dims, x, group):
        return _Replicate.apply(x, group), in_dims[0]


def reduce_sum(x, group):
    """``x`` summed over the ranks of ``group`` (differentiable)."""
    return _Reduce.apply(x, group)


def replicate(x, group):
    """``x`` itself, whose cotangent is summed over the ranks of ``group``."""
    return _Replicate.apply(x, group)


def all_to_all(chunks, recv_shapes, group):
    """Send ``chunks[s]`` to rank ``s`` of ``group`` and return the chunks
    received, ``recv[s]`` from rank ``s`` shaped ``recv_shapes[s]``: one
    ``all_to_all_single`` (complex chunks travel as their real views)."""
    cplx = chunks[0].is_complex()
    dt = chunks[0].dtype
    real = lambda c: torch.view_as_real(c) if cplx else c  # noqa: E731
    dev = backend_device()
    send = torch.cat([real(c.contiguous()).reshape(-1) for c in chunks]).to(dev)
    per = 2 if cplx else 1
    sizes_out = [per * int(torch.Size(s).numel()) for s in recv_shapes]
    recv = send.new_empty(sum(sizes_out))
    dist.all_to_all_single(recv, send, output_split_sizes=sizes_out,
                           input_split_sizes=[per * c.numel() for c in chunks], group=group)
    recv = recv.to(chunks[0].device)
    out = []
    for part, shape in zip(recv.split(sizes_out), recv_shapes):
        out.append(torch.view_as_complex(part.reshape(tuple(shape) + (2,))) if cplx
                   else part.reshape(shape))
    return [o.to(dt) for o in out]


class FieldShards(NamedTuple):
    """The field group and the position keys whose leaves are row shards."""

    group: object
    keys: frozenset


_ACTIVE: Optional[FieldShards] = None


def field() -> Optional[FieldShards]:
    """The active :class:`FieldShards`, or None outside :func:`field_sharded`."""
    return _ACTIVE


@contextlib.contextmanager
def field_sharded(group, keys):
    """Within the block, the tree algebra and the energies sum the leaves
    of ``keys`` and the likelihood's data over ``group`` (see the module's
    docstring); ``group`` None leaves the block unsharded."""
    global _ACTIVE
    before = _ACTIVE
    _ACTIVE = None if group is None else FieldShards(group, frozenset(keys))
    try:
        yield _ACTIVE
    finally:
        _ACTIVE = before
