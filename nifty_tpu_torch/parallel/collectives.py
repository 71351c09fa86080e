"""The collectives of sharded execution: differentiable sums over a group,
the reduce-scatter and all-gather of a response's output, the all-to-all
exchange, and the field context the tree algebra reads.

A field-sharded run keeps on each rank the rows of the excitation field,
and every other leaf of the position whole (replicated).  Its data are
of two kinds, each split along its leading axis: the field's rows, or
the rank's share of the output of a field-aware response (a
line-of-sight integral of the rows, SKI's interpolation of them, or their
type-2 NUFFT, :mod:`.nufft`), which sums the rank's partial output over
the ranks and keeps the rank's share of that sum.  Linear
maps, each pair the other's adjoint, make the reductions exact under
``torch.func`` (grad, jvp, vmap; forward over reverse):

- :func:`reduce_sum`, the sum over the ranks of a group: the energies'
  sums over data rows, the tree algebra's inner products over field rows.
  Its adjoint hands each rank the cotangent (the sum is replicated);
- :func:`replicate`, the identity on a replicated value that enters
  rank-local work (the amplitude's parameters before they colour the
  rank's rows): its adjoint is the sum of the ranks' partial cotangents;
- :func:`reduce_scatter`, the sum over the ranks of a full-length partial
  output, of which rank ``r`` keeps the ``r``-th of ``p`` equal blocks
  along an axis: a field-aware response's output.  Its adjoint is
  :func:`all_gather`, the blocks joined in rank order.  A share rather
  than a replicated sum keeps every datum on one rank, so the energies,
  the noise draws and the χ² sum their data over the group as they do
  for field rows, with nothing counted twice.

:func:`field_sharded` names, while it is active, the group and the
position keys whose leaves are row shards: :func:`~..utils.tree.vdot`,
``dot``, ``norm``, ``sample_vdot`` and ``sample_norm`` sum those leaves'
terms over the group, the likelihoods' energies sum their data over it,
and the white noise of a sample draws, by the counter-based K7, only the
rank's block of the leading axis, the entries at their indices in the
whole leaf, so a sharded run draws the samples of the one-process run.
A model that returns a split value (the field's rows, a field-aware
response's share) notes its shape in the active :class:`FieldShards`
(:func:`note_split`), from which a caller learns what ran and a response
of the field's rows recognises its input (:func:`row_shard`).
Collectives take CUDA tensors under NCCL and CPU tensors under gloo; the
data go where the group needs them.
"""

from __future__ import annotations

import contextlib
import math
from typing import NamedTuple, Optional

import torch
import torch.distributed as dist

from .multihost import backend_device

__all__ = [
    "FieldShards",
    "all_gather",
    "all_to_all",
    "field",
    "field_sharded",
    "note_split",
    "rank_rows",
    "reduce_scatter",
    "reduce_sum",
    "replicate",
    "row_shard",
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


def _leading(x, axis):
    """``x`` with ``axis`` moved to the front, contiguous, complex as its
    real view."""
    x = x.detach().movedim(axis, 0).contiguous()
    return torch.view_as_real(x) if x.is_complex() else x


def _back(buf, like, axis):
    """A result of the leading-axis layout in ``like``'s dtype and device,
    ``axis`` put back."""
    out = torch.view_as_complex(buf) if like.is_complex() else buf
    return out.to(like.device).movedim(0, axis)


def _reduce_scatter(x, axis, group):
    p = dist.get_world_size(group)
    if x.shape[axis] % p:
        raise ValueError(f"axis {axis} of {tuple(x.shape)} does not split over {p} ranks")
    src = _leading(x, axis).to(backend_device())
    out = src.new_empty((src.shape[0] // p,) + tuple(src.shape[1:]))
    dist.reduce_scatter_tensor(out, src, group=group)
    return _back(out, x, axis)


def _all_gather(x, axis, group):
    p = dist.get_world_size(group)
    src = _leading(x, axis).to(backend_device())
    out = src.new_empty((src.shape[0] * p,) + tuple(src.shape[1:]))
    dist.all_gather_into_tensor(out, src, group=group)
    return _back(out, x, axis)


class _ReduceScatter(torch.autograd.Function):
    """Σ over the ranks of ``group``, rank ``r`` keeping block ``r`` of
    ``axis``; the adjoint of :class:`_AllGather`."""

    @staticmethod
    def forward(x, group, axis):
        return _reduce_scatter(x, axis, group)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.group, ctx.axis = inputs[1], inputs[2]

    @staticmethod
    def backward(ctx, grad):
        return _AllGather.apply(grad, ctx.group, ctx.axis), None, None

    @staticmethod
    def jvp(ctx, tangent, *_):
        return _ReduceScatter.apply(tangent, ctx.group, ctx.axis)

    @staticmethod
    def vmap(info, in_dims, x, group, axis):
        # the batch leads: one collective for every sample
        return _ReduceScatter.apply(x.movedim(in_dims[0], 0), group, axis + 1), 0


class _AllGather(torch.autograd.Function):
    """The ranks' blocks of ``axis`` joined in rank order; the adjoint of
    :class:`_ReduceScatter`."""

    @staticmethod
    def forward(x, group, axis):
        return _all_gather(x, axis, group)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.group, ctx.axis = inputs[1], inputs[2]

    @staticmethod
    def backward(ctx, grad):
        return _ReduceScatter.apply(grad, ctx.group, ctx.axis), None, None

    @staticmethod
    def jvp(ctx, tangent, *_):
        return _AllGather.apply(tangent, ctx.group, ctx.axis)

    @staticmethod
    def vmap(info, in_dims, x, group, axis):
        return _AllGather.apply(x.movedim(in_dims[0], 0), group, axis + 1), 0


def reduce_scatter(x, group, axis: int = 0):
    """``x`` summed over the ranks of ``group``, of which this rank keeps
    its block of ``axis`` (``p`` equal blocks in rank order;
    differentiable, its adjoint :func:`all_gather`)."""
    return _ReduceScatter.apply(x, group, axis % x.ndim)


def all_gather(x, group, axis: int = 0):
    """The ranks' ``x`` joined along ``axis`` in rank order
    (differentiable, its adjoint :func:`reduce_scatter`)."""
    return _AllGather.apply(x, group, axis % x.ndim)


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
    """The field group, the position keys whose leaves are row shards, the
    shapes of the split values models returned (``notes``, each once, the
    last returned last; empty before any) and those of them that are the
    field's rows (``rows``)."""

    group: object
    keys: frozenset
    notes: list
    rows: set


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
    _ACTIVE = None if group is None else FieldShards(group, frozenset(keys), [], set())
    try:
        yield _ACTIVE
    finally:
        _ACTIVE = before


def note_split(out, rows: bool = False):
    """Note, in the active :class:`FieldShards`, that ``out`` is split over
    its group along its leading axis: the field's rows (``rows``), or a
    field-aware response's share; ``out`` itself.  A response that takes
    the field's rows knows them by the shapes noted so."""
    if _ACTIVE is not None:
        shape = tuple(out.shape)
        if shape in _ACTIVE.notes:
            _ACTIVE.notes.remove(shape)
        _ACTIVE.notes.append(shape)
        if rows:
            _ACTIVE.rows.add(shape)
    return out


def row_shard(x, grid_shape=None) -> Optional[FieldShards]:
    """The active :class:`FieldShards` where ``x`` has the shape of the
    field's rows a model noted in it (with ``grid_shape``: where ``x`` is
    those rows of a field on that grid, raveled), else None."""
    if _ACTIVE is None:
        return None
    if grid_shape is None:
        return _ACTIVE if tuple(x.shape) in _ACTIVE.rows else None
    p = dist.get_world_size(_ACTIVE.group)
    rows = (grid_shape[0] // p,) + tuple(grid_shape[1:])
    if rows[0] * p == grid_shape[0] and rows in _ACTIVE.rows and tuple(x.shape) == (math.prod(rows),):
        return _ACTIVE
    return None


def rank_rows(group, n_local: int, n_total: int):
    """``(lo, n_local)``: the rows this rank of ``group`` holds of a
    leading axis of ``n_total`` split into equal blocks in rank order."""
    p, r = dist.get_world_size(group), dist.get_rank(group)
    if n_local * p != n_total:
        raise ValueError(f"{n_local} rows a rank over {p} ranks are not the {n_total} rows of the grid")
    return r * n_local, n_local
