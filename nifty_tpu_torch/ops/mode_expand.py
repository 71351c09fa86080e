"""Expansion of unique-|k| mode tables onto harmonic grids (counterpart of
``nifty_tpu/ops/mode_expand.py``).

The exact correlated field stores one amplitude per unique |k| and expands
it onto the harmonic grid.  The index covers the non-redundant core
(``n//2+1`` per axis); on a square grid the core's |k| is symmetric under
transposition, so the index is packed into the rectangular-full-packed
("rfp2") layout, which halves the index.  K1 expands the table straight
onto the full grid (the packed lookup, the unpack and the mirror unfold in
one kernel) and K2 is its adjoint (``cuda_expand.py``).

:class:`ModeExpandGrid` (K1) and :class:`ModeCollapseGrid` (K2) are each
other's adjoints: the backward of one is the other, and the jvp of each is
itself (both are linear).  Backward and jvp re-enter the Function through
``apply``, so under ``torch.func`` transforms the kernel wrappers always
receive plain tensors (``torch.func.jvp`` hands ``jvp`` a wrapped tangent,
which has no data pointer).  Tables are ``(U,)`` or ``(U, B)`` with a
trailing sample axis.  On ``meta`` tensors (``model.eval_shape``) both
return an empty output of the right shape.
"""

from __future__ import annotations

import hashlib
from collections import namedtuple

import numpy as np
import torch

from .cuda_expand import (
    ExpandIndex,
    collapse_from_grid,
    collapse_from_grid_rows,
    expand_to_grid,
    expand_to_grid_rows,
)

__all__ = [
    "ExpandIndex",
    "ExpandLayout",
    "ModeCollapseGrid",
    "ModeCollapseGridRows",
    "ModeExpandGrid",
    "ModeExpandGridRows",
    "build_expand_layout",
    "mode_collapse",
    "mode_expand",
    "mode_expand_grid",
    "mode_expand_grid_rows",
]

ExpandLayout = namedtuple(
    "ExpandLayout",
    ("kind", "core_shape", "packed_shape", "n_unique", "idx_hash"),
)


def _idx_hash(core_idx: np.ndarray) -> str:
    h = hashlib.sha1()
    h.update(str(core_idx.shape).encode())
    h.update(np.ascontiguousarray(core_idx, dtype=np.int64).tobytes())
    return h.hexdigest()[:16]


def _rfp_index_table(core: np.ndarray) -> np.ndarray:
    """Pack the upper triangle of a symmetric (H, H) index table (H odd)
    into the rectangular-full-packed ((H+1)/2, H) layout."""
    H = core.shape[0]
    m = H // 2  # H = 2m + 1
    R = np.empty((m + 1, H), dtype=core.dtype)
    # right block: full rectangle rows 0..m, cols m+1..H-1
    R[:, m + 1 :] = core[: m + 1, m + 1 :]
    # left square S (m+1, m+1): upper triangle holds core[a, b] (a<=b<=m);
    # strict lower S[a, b] (a>b) holds core[m+1+b, m+a]
    aa, bb = np.meshgrid(np.arange(m + 1), np.arange(m + 1), indexing="ij")
    upper = core[: m + 1, : m + 1]
    lower_src = core[np.minimum(m + 1 + bb, H - 1), np.minimum(m + aa, H - 1)]
    R[:, : m + 1] = np.where(aa <= bb, upper, lower_src)
    return R


def build_expand_layout(core_idx: np.ndarray, n_unique: int):
    """Static layout and packed int32 index for a mode table.

    Returns ``(packed_idx, layout)``, both numpy / plain Python; wrap them
    in an :class:`ExpandIndex` to use them on tensors.
    """
    core_idx = np.asarray(core_idx)
    core_shape = tuple(int(n) for n in core_idx.shape)
    if (
        core_idx.ndim == 2
        and core_shape[0] == core_shape[1]
        and core_shape[0] % 2 == 1
        and np.array_equal(core_idx, core_idx.T)
    ):
        R = np.ascontiguousarray(_rfp_index_table(core_idx), dtype=np.int32)
        return R, ExpandLayout(
            kind="rfp2",
            core_shape=core_shape,
            packed_shape=tuple(int(n) for n in R.shape),
            n_unique=int(n_unique),
            idx_hash=_idx_hash(R),
        )
    return np.ascontiguousarray(core_idx, dtype=np.int32), ExpandLayout(
        kind="flat",
        core_shape=core_shape,
        packed_shape=core_shape,
        n_unique=int(n_unique),
        idx_hash=_idx_hash(core_idx),
    )


def _kernel_input(t):
    t = t.contiguous()
    if t.is_cuda and t.data_ptr() % 16:
        t = t.clone()  # K1/K2 load 16-byte vectors at B % 4 == 0; a fresh buffer is aligned
    return t


def _batched_apply(fn, x, bdim, n_lead, index, full_shape):
    """The vmap rule of K1 and K2: the mapped axis ``bdim`` of ``x`` joins
    the kernels' trailing sample axis, so a batch is one launch.  ``x`` has
    ``n_lead`` axes before its own sample axis (if any); the result has the
    mapped axis last."""
    x = x.movedim(bdim, -1)
    batch = tuple(x.shape[n_lead:])
    out = fn(x.reshape(tuple(x.shape[:n_lead]) + (-1,)), index, full_shape)
    return out.reshape(tuple(out.shape[:-1]) + batch), -1


class ModeExpandGrid(torch.autograd.Function):
    """``tab`` (U,) / (U, B) -> ``full_shape`` grid (+ trailing B), through K1.
    Under ``torch.func.vmap`` the mapped axis becomes K1's ``B``."""

    @staticmethod
    def forward(tab, index, full_shape):
        if tab.is_meta:  # shapes only (eval_shape): no index read, no launch
            return tab.new_empty(tuple(full_shape) + tuple(tab.shape[1:]))
        return expand_to_grid(_kernel_input(tab), index, full_shape)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.index, ctx.full_shape = inputs[1], inputs[2]

    @staticmethod
    def backward(ctx, grad):
        return ModeCollapseGrid.apply(grad, ctx.index, ctx.full_shape), None, None

    @staticmethod
    def jvp(ctx, tab_t, *_):
        return ModeExpandGrid.apply(tab_t, ctx.index, ctx.full_shape)

    @staticmethod
    def vmap(info, in_dims, tab, index, full_shape):
        return _batched_apply(ModeExpandGrid.apply, tab, in_dims[0], 1, index, full_shape)


class ModeCollapseGrid(torch.autograd.Function):
    """``full_shape`` grid cotangent (+ trailing B) -> (U,) / (U, B), through K2.
    Under ``torch.func.vmap`` the mapped axis becomes K2's ``B``."""

    @staticmethod
    def forward(cot, index, full_shape):
        if cot.is_meta:  # shapes only (eval_shape): no index read, no launch
            return cot.new_empty((index.n_unique,) + tuple(cot.shape[len(full_shape):]))
        return collapse_from_grid(_kernel_input(cot), index, full_shape)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.index, ctx.full_shape = inputs[1], inputs[2]

    @staticmethod
    def backward(ctx, grad):
        return ModeExpandGrid.apply(grad, ctx.index, ctx.full_shape), None, None

    @staticmethod
    def jvp(ctx, cot_t, *_):
        return ModeCollapseGrid.apply(cot_t, ctx.index, ctx.full_shape)

    @staticmethod
    def vmap(info, in_dims, cot, index, full_shape):
        return _batched_apply(
            ModeCollapseGrid.apply, cot, in_dims[0], len(full_shape), index, full_shape
        )


class ModeExpandGridRows(torch.autograd.Function):
    """``tab`` -> the rows ``rows = (lo, n)`` of the ``full_shape`` grid,
    through K1r; its adjoint is :class:`ModeCollapseGridRows` (K2r), whose
    table is this range's part of the cotangent."""

    @staticmethod
    def forward(tab, index, full_shape, rows):
        if tab.is_meta:
            return tab.new_empty((rows[1],) + tuple(full_shape[1:]) + tuple(tab.shape[1:]))
        return expand_to_grid_rows(_kernel_input(tab), index, full_shape, rows)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.index, ctx.full_shape, ctx.rows = inputs[1:]

    @staticmethod
    def backward(ctx, grad):
        return ModeCollapseGridRows.apply(grad, ctx.index, ctx.full_shape, ctx.rows), None, None, None

    @staticmethod
    def jvp(ctx, tab_t, *_):
        return ModeExpandGridRows.apply(tab_t, ctx.index, ctx.full_shape, ctx.rows)

    @staticmethod
    def vmap(info, in_dims, tab, index, full_shape, rows):
        fn = lambda t, i, f: ModeExpandGridRows.apply(t, i, f, rows)  # noqa: E731
        return _batched_apply(fn, tab, in_dims[0], 1, index, full_shape)


class ModeCollapseGridRows(torch.autograd.Function):
    """The cotangent of the rows ``rows = (lo, n)`` of the ``full_shape``
    grid -> this range's part of the table cotangent, through K2r."""

    @staticmethod
    def forward(cot, index, full_shape, rows):
        if cot.is_meta:
            return cot.new_empty((index.n_unique,) + tuple(cot.shape[len(full_shape):]))
        return collapse_from_grid_rows(_kernel_input(cot), index, full_shape, rows)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.index, ctx.full_shape, ctx.rows = inputs[1:]

    @staticmethod
    def backward(ctx, grad):
        return ModeExpandGridRows.apply(grad, ctx.index, ctx.full_shape, ctx.rows), None, None, None

    @staticmethod
    def jvp(ctx, cot_t, *_):
        return ModeCollapseGridRows.apply(cot_t, ctx.index, ctx.full_shape, ctx.rows)

    @staticmethod
    def vmap(info, in_dims, cot, index, full_shape, rows):
        fn = lambda c, i, f: ModeCollapseGridRows.apply(c, i, f, rows)  # noqa: E731
        return _batched_apply(fn, cot, in_dims[0], len(full_shape), index, full_shape)


def mode_expand_grid_rows(tab, index: ExpandIndex, full_shape, rows):
    """The rows ``rows = (lo, n)`` of :func:`mode_expand_grid`."""
    return ModeExpandGridRows.apply(tab, index, tuple(full_shape), (int(rows[0]), int(rows[1])))


def mode_expand_grid(tab, index: ExpandIndex, full_shape):
    """Expand per-unique-mode values onto the full harmonic grid: exactly
    the core expansion :func:`mode_expand` followed by the mirror unfold
    (position ``i >= n//2+1`` takes the value at ``n-i``)."""
    return ModeExpandGrid.apply(tab, index, tuple(full_shape))


def mode_expand(tab, index: ExpandIndex):
    """Expand per-unique-mode values onto the core harmonic grid.

    Exactly equal to ``tab[core_idx]``; its transpose is the segment sum
    over the mode bins (:func:`mode_collapse`)."""
    return ModeExpandGrid.apply(tab, index, tuple(index.layout.core_shape))


def mode_collapse(cot, index: ExpandIndex):
    """The adjoint of :func:`mode_expand`."""
    return ModeCollapseGrid.apply(cot, index, tuple(index.layout.core_shape))
