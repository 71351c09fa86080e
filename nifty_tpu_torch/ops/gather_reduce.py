"""Sparse matrices as padded row tables, applied by a weighted gather-reduce.

A sparse ``(rows, n_cols)`` matrix A is held as two padded ``(rows,
width)`` tables, ``idx`` (int64 column indices) and ``wgt`` (weights,
zero in the padding): ``(A x)[r] = Σ_j wgt[r, j] · x[idx[r, j]]``.  This
is the apply of the exact line-of-sight response (``los.py``) and of the
SKI interpolation matrix (``ski.py``); the JAX package computes both with
``jnp.take`` and a reduction, and transposes them by AD into a
scatter-add.

The transpose here is a gather too: numpy sorts the table's non-zero
entries by column once, at construction, into a column-major padded
table (``t_rows``, ``t_wgt``) over the columns that occur (``cols``), and
``Aᵀ y`` gathers ``y`` along it, sums each column's row and writes the
sums to their columns (each once).  No float atomics run, so a
pull-back gives the same bits on every call on the card, which the
autograd of ``x[idx]`` (an accumulating ``index_put_``) does not.

:class:`GatherReduce` (A) and :class:`GatherReduceT` (Aᵀ) are each
other's backward, the jvp of each is itself (both are linear), and each
has a ``torch.func.vmap`` rule that moves the mapped axis to a leading
batch axis, so a batch of samples is one gather.  Inputs are ``(n_cols,)``
or ``(B, n_cols)``; complex inputs take real weights.  The batch leads:
gathering the rows of a trailing batch, ``(n_cols, B)``, took torch's
``vectorized_gather_kernel`` 60 ms a launch at 1280² with 16,384 rays on
an H100, against ~0.3 ms for one sample's gather
(``bench/metric_profile.py --los 16384 [--vi]``).

On a row-sharded field a rank holds a block of the columns (the raveled
cells of its rows).  :func:`column_block` cuts the tables to the entries
of such a block, in numpy: the block's matrix gives the rank's partial
product over every row (ray), which a reduce-scatter over the ranks
(:func:`~..parallel.collectives.reduce_scatter`) turns into the rank's
share of the rows of ``A x``; the pull-back all-gathers the cotangent and
gathers it along the block's own cell-major table, deterministic as
before.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import device as _device

__all__ = ["GatherReduce", "GatherReduceT", "PaddedSparse", "RowBlocks", "column_block",
           "transpose_block"]


def _weights(t, x):
    return t.to(x.real.dtype if x.is_complex() else x.dtype)


def _batched(fn, x, bdim, table):
    """The vmap rule of both Functions: the mapped axis joins the leading
    batch axis, the result has it first."""
    x = x.movedim(bdim, 0)
    batch = tuple(x.shape[:-1])
    out = fn(x.reshape(-1, x.shape[-1]), table)
    return out.reshape(batch + (out.shape[-1],)), 0


class GatherReduce(torch.autograd.Function):
    """``A x``: ``x`` (n_cols,) or (B, n_cols) -> (rows,) or (B, rows)."""

    @staticmethod
    def forward(x, table):
        if x.is_meta:  # shapes only (eval_shape)
            return x.new_empty(tuple(x.shape[:-1]) + (table.idx.shape[0],))
        return (_weights(table.wgt, x) * x[..., table.idx]).sum(-1)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.table = inputs[1]

    @staticmethod
    def backward(ctx, grad):
        return GatherReduceT.apply(grad, ctx.table), None

    @staticmethod
    def jvp(ctx, x_t, _):
        return GatherReduce.apply(x_t, ctx.table)

    @staticmethod
    def vmap(info, in_dims, x, table):
        return _batched(GatherReduce.apply, x, in_dims[0], table)


class GatherReduceT(torch.autograd.Function):
    """``Aᵀ y``: ``y`` (rows,) or (B, rows) -> (n_cols,) or (B, n_cols), by
    the column-major table: deterministic."""

    @staticmethod
    def forward(y, table):
        shape = tuple(y.shape[:-1]) + (table.n_cols,)
        if y.is_meta:
            return y.new_empty(shape)
        hit = (_weights(table.t_wgt, y) * y[..., table.t_rows]).sum(-1)
        if table.all_cols:
            return hit
        return y.new_zeros(shape).index_copy(-1, table.cols, hit)  # each column once

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.table = inputs[1]

    @staticmethod
    def backward(ctx, grad):
        return GatherReduce.apply(grad, ctx.table), None

    @staticmethod
    def jvp(ctx, y_t, _):
        return GatherReduceT.apply(y_t, ctx.table)

    @staticmethod
    def vmap(info, in_dims, y, table):
        return _batched(GatherReduceT.apply, y, in_dims[0], table)


def transpose_tables(idx, wgt):
    """The column-major table of the non-zero entries of ``(idx, wgt)``:
    ``(cols, t_rows, t_wgt)``, ``cols`` the sorted columns that occur, row
    ``c`` of ``t_rows``/``t_wgt`` the rows and weights of column
    ``cols[c]`` in ascending row order, padded with weight 0."""
    rows, slots = np.nonzero(wgt)
    col = idx[rows, slots]
    order = np.argsort(col, kind="stable")
    col, rows, w = col[order], rows[order], wgt[rows, slots][order]
    first = np.flatnonzero(np.diff(col, prepend=-1))  # where each column's run starts
    cols = col[first]
    counts = np.diff(first, append=col.size)
    width = int(counts.max()) if counts.size else 1
    which = np.repeat(np.arange(cols.size), counts)
    slot = np.arange(col.size) - first[which]
    t_rows = np.zeros((cols.size, width), np.int64)
    t_wgt = np.zeros((cols.size, width), wgt.dtype)
    t_rows[which, slot] = rows
    t_wgt[which, slot] = w
    return cols, t_rows, t_wgt


def column_block(idx, wgt, lo: int, hi: int):
    """The entries of the padded tables ``(idx, wgt)`` (numpy) whose column
    lies in ``[lo, hi)``: tables of every row, their columns shifted by
    ``-lo`` (int64), each row's entries in their order, padded with weight
    0 to the widest row of the block."""
    idx = np.asarray(idx, np.int64)
    wgt = np.asarray(wgt)
    mask = idx >= lo
    mask &= idx < hi
    mask &= wgt != 0
    flat = np.flatnonzero(mask)  # row-major: each row's entries in their order
    rows = flat // idx.shape[1]
    counts = np.bincount(rows, minlength=idx.shape[0])
    first = np.concatenate(([0], np.cumsum(counts)[:-1]))
    width = max(int(counts.max()) if counts.size else 0, 1)
    dest = rows * width + (np.arange(flat.size) - first[rows])
    b_idx = np.zeros((idx.shape[0], width), np.int64)
    b_wgt = np.zeros((idx.shape[0], width), wgt.dtype)
    b_idx.reshape(-1)[dest] = idx.reshape(-1)[flat] - lo
    b_wgt.reshape(-1)[dest] = wgt.reshape(-1)[flat]
    return b_idx, b_wgt


def transpose_block(cols, t_rows, t_wgt, lo: int, hi: int):
    """The cell-major tables (:func:`transpose_tables`) of the columns
    ``[lo, hi)``: a slice of the whole matrix's, sorted by column, their
    columns shifted by ``-lo`` and cut to the block's busiest column; the
    same as :func:`transpose_tables` of :func:`column_block`'s tables."""
    a, b = np.searchsorted(cols, [lo, hi])
    counts = (t_wgt[a:b] != 0).sum(1)
    width = max(int(counts.max()) if counts.size else 0, 1)
    return cols[a:b] - lo, t_rows[a:b, :width], t_wgt[a:b, :width]


class RowBlocks(torch.nn.ModuleDict):
    """The matrices of row ranges of a grid of ``grid_shape`` (its cells
    raveled row-major), cut from a sparse matrix over its cells given by
    the numpy tables ``(idx, wgt)`` and the cell-major ``t_tables``
    (:func:`transpose_tables`).  ``blocks(lo, n, like)`` is the
    :class:`PaddedSparse` of the rows ``[lo, lo + n)`` over their cells
    (:func:`column_block`, :func:`transpose_block`), cut at the first call
    and kept under ``f"{lo}_{n}"``, on the device and in the dtype of the
    tensor ``like``."""

    def __init__(self, idx, wgt, t_tables, grid_shape):
        super().__init__()
        self._tables = (idx, wgt) + tuple(t_tables)
        self._row_cells = int(np.prod(grid_shape[1:]))

    def forward(self, lo: int, n: int, like) -> "PaddedSparse":
        key = f"{lo}_{n}"
        if key not in self:
            c0, c1 = lo * self._row_cells, (lo + n) * self._row_cells
            self[key] = PaddedSparse(*column_block(*self._tables[:2], c0, c1), c1 - c0,
                                     device=like.device, dtype=like.dtype,
                                     transpose=transpose_block(*self._tables[2:], c0, c1))
        return self[key]


class PaddedSparse(torch.nn.Module):
    """A sparse ``(rows, n_cols)`` matrix from padded tables ``idx`` (column
    indices) and ``wgt`` (weights, 0 in the padding), both ``(rows,
    width)`` numpy, on ``device`` (the CUDA card by default) with weights
    in ``dtype`` (the default floating dtype by default).  ``A @ x`` and
    ``A.T @ y`` take vectors or matrices (a matrix's columns as one
    batch); ``todense()`` for tests.  Repeated columns in a row add up, as
    in a BCOO.  ``transpose`` takes the cell-major tables when they are
    known (:func:`transpose_block`), else they are built here."""

    def __init__(self, idx, wgt, n_cols: int, *, device=None, dtype=None, transpose=None):
        super().__init__()
        device = _device.resolve(device)
        dtype = dtype or torch.get_default_dtype()
        idx = np.asarray(idx, np.int64)
        wgt = np.asarray(wgt)
        if idx.shape != wgt.shape or idx.ndim != 2:
            raise ValueError(f"idx {idx.shape} and wgt {wgt.shape} must be equal (rows, width)")
        if idx.size and (idx.min() < 0 or idx.max() >= n_cols):
            raise ValueError(f"column indices outside [0, {n_cols})")
        self.n_cols = int(n_cols)
        cols, t_rows, t_wgt = transpose if transpose is not None else transpose_tables(idx, wgt)
        self.all_cols = cols.size == self.n_cols
        for name, a in (("idx", idx), ("wgt", wgt), ("cols", cols), ("t_rows", t_rows),
                        ("t_wgt", t_wgt)):
            fp = np.issubdtype(a.dtype, np.floating)
            self.register_buffer(name, torch.as_tensor(a, device=device, dtype=dtype if fp else None))

    @property
    def shape(self):
        return (self.idx.shape[0], self.n_cols)

    @property
    def T(self):
        return _Transposed(self)

    def __matmul__(self, x):
        return _columns(GatherReduce.apply, x, self)

    def rmatvec(self, y):
        """``Aᵀ y``."""
        return _columns(GatherReduceT.apply, y, self)

    def todense(self):
        rows = torch.arange(self.idx.shape[0], device=self.idx.device)[:, None].expand_as(self.idx)
        dense = self.wgt.new_zeros(self.shape)
        return dense.index_put_((rows.reshape(-1), self.idx.reshape(-1)), self.wgt.reshape(-1),
                                accumulate=True)

    def table_bytes(self) -> int:
        """The bytes of both tables on the device."""
        return sum(b.numel() * b.element_size() for b in self.buffers())


def _columns(fn, x, table):
    """``fn`` of a vector, or of each column of a matrix (as one batch)."""
    if x.ndim == 1:
        return fn(x, table)
    if x.ndim != 2:
        raise ValueError(f"a vector or a matrix, not shape {tuple(x.shape)}")
    return fn(x.mT, table).mT


class _Transposed:
    """``A.T`` of a :class:`PaddedSparse`: ``A.T @ y`` and ``A.T.T``."""

    def __init__(self, a):
        self.a = a

    @property
    def shape(self):
        return self.a.shape[::-1]

    @property
    def T(self):
        return self.a

    def __matmul__(self, y):
        return self.a.rmatvec(y)

    def todense(self):
        return self.a.todense().T
