"""The mode-table expansion on the card: K1 (table -> full grid) and K2
(full-grid cotangent -> table).

K1 replaces the Pallas kernel ``nifty_tpu/ops/pallas_expand.py:forward_fn``
(``out[p] = tab[idx[p]]`` on the packed index) together with the layout ops
the JAX package runs after it: the unpack of the rfp2 packing onto the
``(H, H)`` core and the mirror unfold of the core onto the full harmonic
grid.  K2 replaces ``:transpose_fn`` (the segment sum over the mode bins)
with the mirror's and the unpack's adjoints in front of it.  On the TPU
the kernels ran a Clos routing network of lane shuffles, because XLA:TPU
gathers cost a fixed ~7 ns per index.  On Hopper both are bound by the
bytes of the full grid; ``csrc/expand.cu`` says how each kernel answers
that.

Both take ``(U,)`` tables and ``(U, B)`` tables batched over a trailing
sample axis; the grid side is ``full_shape`` (+ ``B``), where each axis of
the full shape is either the core's (not mirrored) or ``2 (c - 1)`` or
``2 c - 1`` for a core of ``c`` (mirrored: position ``i >= n//2+1`` takes
the value at ``n - i``).  K2 reduces over a CSR permutation of the packed
index that :class:`ExpandIndex` builds once on the host, in a fixed order
without atomics, so its sums are deterministic.

K1r :func:`expand_to_grid_rows` and K2r :func:`collapse_from_grid_rows`
are K1 and K2 on a range ``lo .. lo + n - 1`` of the grid's leading axis,
for a row-sharded field, with work that follows the range: the core rows
whose images the range holds are one interval (:func:`core_rows`),
and the kernels launch only the tiles (rfp2) or core rows (flat) that meet
them.  K1r writes the range's rows; K2r folds them and sums, through the
range's own CSR (:class:`ExpandRows`, built once a range and kept on the
index), only the packed points with an image in the range: its table is
this range's part of the table cotangent, every other bin 0.

Each wrapper runs its plain PyTorch version (the composition of
``index_select``, the rfp2 unpack and the mirror unfold, and its adjoint
ending in ``index_add_``) when its tensor lies on the CPU; for a CUDA
tensor it launches its kernel or raises.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import native

__all__ = [
    "LARGE_BIN",
    "MAX_GRID_YZ",
    "ExpandIndex",
    "ExpandRows",
    "collapse_from_grid",
    "collapse_from_grid_plain",
    "collapse_from_grid_rows",
    "collapse_from_grid_rows_plain",
    "core_rows",
    "expand_to_grid",
    "expand_to_grid_plain",
    "expand_to_grid_rows",
    "expand_to_grid_rows_plain",
    "grid_geometry",
    "launch_rows",
    "mirror_fold",
    "mirror_unfold",
    "needed_packed",
    "row_range",
    "segment_csr",
]

LARGE_BIN = 32  # bins with more members than this are reduced by a warp
MAX_GRID_YZ = 65535  # a launch grid's y and z extents
TILE = 32  # the rfp2 kernels' tiles: 32 x 32 core points
DENSE = 0.9  # K2r takes the whole index's CSR when a range has this share of the packed points


def segment_csr(idx: np.ndarray, n_unique: int):
    """CSR form of the bins of ``idx``: the stable argsort of the index,
    the bin offsets into it, and the bins of more than :data:`LARGE_BIN`
    members."""
    idx = np.asarray(idx).ravel()
    perm = np.argsort(idx, kind="stable")
    counts = np.bincount(idx, minlength=n_unique)
    offsets = np.concatenate([[0], np.cumsum(counts)])
    as32 = lambda a: torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32))
    return as32(perm), as32(offsets), as32(np.flatnonzero(counts > LARGE_BIN))


class ExpandIndex(torch.nn.Module):
    """A packed mode index and its CSR form, as buffers that follow the
    model to its device.  ``layout`` is the static
    :class:`~.mode_expand.ExpandLayout`."""

    def __init__(self, packed_idx, layout):
        super().__init__()
        idx = np.asarray(packed_idx).ravel()
        if idx.size and (idx.min() < 0 or idx.max() >= layout.n_unique):
            raise ValueError("mode index out of range")
        self.layout = layout
        self.register_buffer(
            "idx", torch.from_numpy(np.ascontiguousarray(idx, dtype=np.int32))
        )
        perm, offsets, large = segment_csr(idx, layout.n_unique)
        self.register_buffer("perm", perm)
        self.register_buffer("offsets", offsets)
        self.register_buffer("large_bins", large)
        self.ranges = torch.nn.ModuleDict()  # row_tables' CSRs, by range

    @property
    def n_packed(self) -> int:
        return self.idx.numel()

    @property
    def n_unique(self) -> int:
        return self.layout.n_unique

    def row_tables(self, full_shape, rows) -> "ExpandRows":
        """The CSR of the rows ``rows = (lo, n)`` of the ``full_shape`` grid
        (:class:`ExpandRows`), built on the index's device at first use and
        kept as a submodule, so it follows the index to its device."""
        key = "_".join(str(int(v)) for v in tuple(full_shape) + tuple(rows))
        if key not in self.ranges:
            self.ranges[key] = ExpandRows(self, full_shape, rows)
        return self.ranges[key]


def core_rows(n, c, lo, b):
    """The core rows ``(start, length)`` whose images on an axis of ``n``
    points with core ``c`` (``n``, or ``n//2 + 1`` when mirrored) are among
    the rows ``lo .. lo + b - 1``: rows below ``c`` are their own, a row ``y
    >= c`` is core row ``n - y``.  One interval: the rows below ``c`` map to
    ``[lo, c)``, those from ``c`` on to ``[n - hi + 1, n - c]`` with ``n - c
    >= c - 2``, so when a range holds both, the two meet."""
    hi = lo + b
    if c == n or hi <= c:
        return lo, b
    start, end = n - hi + 1, n - max(lo, c) + 1  # the mirrored rows
    if lo < c:
        start, end = min(start, lo), c
    return start, end - start


@functools.lru_cache(maxsize=256)
def launch_rows(layout, full_shape, rows):
    """The kernels' launch rows ``(k_lo, k_n)`` of the range ``rows = (lo,
    n)`` on the grid's leading axis: :func:`core_rows` in units of the rfp2
    tiles' 32 rows, or in core rows for a flat layout."""
    s, n = core_rows(int(full_shape[0]), int(layout.core_shape[0]), int(rows[0]), int(rows[1]))
    step = TILE if layout.kind == "rfp2" else 1
    return s // step, -(-(s + n) // step) - s // step


def needed_packed(index, full_shape, rows):
    """A boolean per packed point: whether one of its full-grid images lies
    in the rows ``rows = (lo, n)`` of the leading axis, i.e. whether its
    core point, or for rfp2 its transpose, has its leading coordinate among
    :func:`core_rows`."""
    layout, dev = index.layout, index.idx.device
    c = int(layout.core_shape[0])
    mask = torch.zeros(c, dtype=torch.bool, device=dev)
    s, n = core_rows(int(full_shape[0]), c, int(rows[0]), int(rows[1]))
    mask[s:s + n] = True
    pos = torch.arange(index.n_packed, device=dev)
    if layout.kind == "rfp2":  # packed (r, q): core (r, q) if q >= r, else (m+1+q, m+r)
        H, m = c, c // 2
        r, q = pos // H, pos % H
        direct = q >= r
        return mask[torch.where(direct, r, m + 1 + q)] | mask[torch.where(direct, q, m + r)]
    return mask[pos // int(np.prod(layout.core_shape[1:], dtype=np.int64))]


class ExpandRows(torch.nn.Module):
    """K2r's CSR of one row range (buffers that follow the index): ``perm``,
    the packed points with an image in the range in the order of the
    index's own CSR (by bin, stable); ``bins``, the bins they touch, in
    order; ``offsets``, each touched bin's first place in ``perm`` (and the
    end); ``large_bins``, the places in ``bins`` of those with more than
    :data:`LARGE_BIN` members.  Built from the index's CSR by a mask, no
    sort.  ``dense``: the range has an image of at least :data:`DENSE` of
    the packed points, and K2r folds every tile and sums every bin through
    the index's own CSR (no zero fill: faster when few points drop out);
    its tables are then empty."""

    def __init__(self, index, full_shape, rows):
        super().__init__()
        with torch.no_grad():
            perm = index.perm[needed_packed(index, full_shape, rows)[index.perm.long()]]
            self.dense = perm.numel() >= DENSE * index.n_packed
            if self.dense:
                perm = perm[:0]
            counts = torch.bincount(index.idx[perm.long()], minlength=index.n_unique)
            bins = torch.nonzero(counts).reshape(-1)
            counts = counts[bins]
            offsets = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)])
            large = torch.nonzero(counts > LARGE_BIN).reshape(-1)
        for name, t in (("perm", perm), ("bins", bins), ("offsets", offsets), ("large_bins", large)):
            self.register_buffer(name, t.to(torch.int32), persistent=False)

    @property
    def n_bins(self) -> int:
        return self.bins.numel()

    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self.buffers())


def grid_geometry(layout, full_shape):
    """The kernels' geometry ``(n0, n1, n2, c0, c1, c2, m)``: the full and
    core shapes with leading axes of 1 up to three axes, and ``m = H // 2``
    for an rfp2 layout (its two axes last), else -1.  Raises unless each
    full axis is its core's or that core's mirror unfold."""
    core = tuple(layout.core_shape)
    full = tuple(int(n) for n in full_shape)
    if len(full) != len(core) or not 1 <= len(core) <= 3:
        raise ValueError(f"full shape {full} does not fit the core {core}")
    for n, c in zip(full, core):
        if n != c and n // 2 + 1 != c:
            raise ValueError(f"full shape {full} does not fit the core {core}")
    pad = (1,) * (3 - len(core))
    m = core[0] // 2 if layout.kind == "rfp2" else -1
    return pad + full + pad + core + (m,)


def row_range(full_shape, rows=None):
    """The kernels' row range ``(r_ax, r_lo, r_n)``: the range ``rows = (lo,
    n)`` of the grid's leading axis (all of it by default), which is
    kernel axis ``r_ax`` of :func:`grid_geometry`'s three."""
    full = tuple(int(n) for n in full_shape)
    lo, n = (0, full[0]) if rows is None else (int(rows[0]), int(rows[1]))
    if lo < 0 or n < 1 or lo + n > full[0]:
        raise ValueError(f"rows {rows} outside the leading axis of {full}")
    return (3 - len(full), lo, n)


def _local_shape(full_shape, rows):
    """``full_shape`` with its leading axis cut to the range ``rows``."""
    return (int(rows[1]),) + tuple(int(n) for n in full_shape[1:])


def mirror_unfold(core, full_shape, rows=None):
    """Expand a core array (``n//2+1`` per axis, or ``n`` where an axis is
    not mirrored) to the full Fourier grid: position ``i >= n//2+1`` takes
    the value at ``n-i``.  Trailing axes beyond ``full_shape`` ride along.
    With ``rows = (lo, n)`` only the rows ``lo .. lo + n - 1`` of the
    leading axis (those of a row-sharded field)."""
    if rows is not None:  # the rows' core rows first: O(rows n1) work and memory
        n0, c0 = int(full_shape[0]), core.shape[0]
        if c0 not in (n0, n0 // 2 + 1):
            raise ValueError(f"core shape {tuple(core.shape)} does not fit {full_shape}")
        i = torch.arange(int(rows[0]), int(rows[0]) + int(rows[1]), device=core.device)
        src = i if c0 == n0 else torch.where(i < c0, i, n0 - i)
        return mirror_unfold(core.index_select(0, src), _local_shape(full_shape, rows))
    out = core
    for axis, n in enumerate(full_shape):
        if out.shape[axis] == n:
            continue
        h = n // 2 + 1
        if out.shape[axis] != h:
            raise ValueError(f"core shape {tuple(core.shape)} does not fit {full_shape}")
        mirror = out.narrow(axis, 1, n - h).flip(axis)
        out = torch.cat([out, mirror], dim=axis)
    return out


def mirror_fold(cot, core_shape):
    """Exact adjoint of :func:`mirror_unfold`: full grid -> core."""
    out = cot
    for axis, h in enumerate(core_shape):
        n = out.shape[axis]
        if n == h:
            continue
        core = out.narrow(axis, 0, h)
        mirror = out.narrow(axis, h, n - h).flip(axis)
        pad = [0, 0] * (out.ndim - axis - 1) + [1, h - 1 - (n - h)]
        out = core + torch.nn.functional.pad(mirror, pad)
    return out


def _sym_from_upper(up):
    """(..., n, n) upper-triangular (incl. diagonal) -> symmetric."""
    return up + torch.triu(up, 1).transpose(-2, -1)


def _upper_cot(cot):
    """Adjoint of :func:`_sym_from_upper`."""
    return torch.triu(cot) + torch.triu(cot.transpose(-2, -1), 1)


def _unpack_rfp2(G, layout):
    """(B, m+1, H) packed values -> (B, H, H) core."""
    m = layout.core_shape[0] // 2
    S = G[..., :, : m + 1]
    rect = G[..., :, m + 1 :]
    C11 = _sym_from_upper(torch.triu(S))
    B2u = torch.tril(S, -1).transpose(-2, -1)  # [b, a] holds core[m+1+b, m+a]
    C22 = _sym_from_upper(B2u[..., :m, 1:])
    top = torch.cat([C11, rect], dim=-1)
    bottom = torch.cat([rect.transpose(-2, -1), C22], dim=-1)
    return torch.cat([top, bottom], dim=-2)


def _fold_rfp2(cot, layout):
    """Exact adjoint of :func:`_unpack_rfp2`: (B, H, H) -> (B, m+1, H)."""
    m = layout.core_shape[0] // 2
    u11 = cot[..., : m + 1, : m + 1]
    u12 = cot[..., : m + 1, m + 1 :]
    u21 = cot[..., m + 1 :, : m + 1]
    u22 = cot[..., m + 1 :, m + 1 :]
    rect_cot = u12 + u21.transpose(-2, -1)
    tri_cot = torch.triu(_upper_cot(u11))
    b2u_cot = torch.nn.functional.pad(_upper_cot(u22), (1, 0, 0, 1))
    s_lower_cot = torch.tril(b2u_cot.transpose(-2, -1), -1)
    return torch.cat([tri_cot + s_lower_cot, rect_cot], dim=-1)


def expand_to_grid_plain(tab, index: ExpandIndex, full_shape):
    """Plain version of K1: ``tab[idx]``, the rfp2 unpack, the mirror
    unfold."""
    layout = index.layout
    single = tab.ndim == 1
    G = tab.index_select(0, index.idx)
    G = G.reshape(layout.packed_shape + (() if single else (tab.shape[-1],)))
    if layout.kind == "rfp2":
        G2 = G[None] if single else torch.movedim(G, -1, 0)
        core = _unpack_rfp2(G2, layout)
        G = core[0] if single else torch.movedim(core, 0, -1)
    return mirror_unfold(G, full_shape)


def collapse_from_grid_plain(cot, index: ExpandIndex, full_shape):
    """Plain version of K2: the mirror fold, the rfp2 fold and
    ``index_add_`` over the bins."""
    layout = index.layout
    single = cot.ndim == len(full_shape)
    core = mirror_fold(cot, layout.core_shape)
    if layout.kind == "rfp2":
        c2 = core[None] if single else torch.movedim(core, -1, 0)
        R = _fold_rfp2(c2, layout)
        core = R[0] if single else torch.movedim(R, 0, -1)
    flat = core.reshape((-1,) if single else (-1, cot.shape[-1]))
    out = cot.new_zeros((index.n_unique,) + tuple(cot.shape[len(full_shape) :]))
    return out.index_add_(0, index.idx, flat)


def expand_to_grid_rows_plain(tab, index: ExpandIndex, full_shape, rows):
    """Plain version of K1r: the rows ``lo .. lo + n - 1`` (``rows = (lo,
    n)``) of :func:`expand_to_grid_plain`."""
    return expand_to_grid_plain(tab, index, full_shape).narrow(0, int(rows[0]), int(rows[1]))


def collapse_from_grid_rows_plain(cot, index: ExpandIndex, full_shape, rows):
    """Plain version of K2r: :func:`collapse_from_grid_plain` of the
    cotangent of the rows ``rows = (lo, n)`` padded with zeros to the full
    grid."""
    lo, n = int(rows[0]), int(rows[1])
    full = cot.new_zeros(tuple(full_shape) + tuple(cot.shape[len(full_shape):]))
    full.narrow(0, lo, n).copy_(cot)
    return collapse_from_grid_plain(full, index, full_shape)


def _check_cuda(t, index, shape, what):
    native.require_cuda(t, what, torch.float32, t.ndim in (len(shape), len(shape) + 1)
                        and tuple(t.shape[: len(shape)]) == tuple(shape))
    if index.idx.device != t.device:
        raise ValueError(f"{what}: index on {index.idx.device}, values on {t.device}")
    B = t.shape[-1] if t.ndim > len(shape) else 1
    vec = 16 if B % 4 == 0 else 8 if B % 2 == 0 else 4
    if t.data_ptr() % vec:
        raise ValueError(
            f"{what}: a batch of {B} is read in {vec}-byte vectors; "
            f"the tensor must start on a {vec}-byte boundary"
        )


def _launch_geometry(index, full_shape, what, rows=None, skip=True):
    """The kernels' geometry; for a range with ``skip`` its launch rows,
    else ``k_n = 0``: every tile or core row."""
    geom = grid_geometry(index.layout, full_shape) + row_range(full_shape, rows)
    if max(geom[3:5]) > MAX_GRID_YZ:  # the core's rows and slabs are grid extents
        raise ValueError(f"{what}: core {index.layout.core_shape} is too large for a launch grid")
    if rows is not None and len(full_shape) < 2:
        raise ValueError(f"{what}: a row range needs a grid of 2 or 3 axes, not {tuple(full_shape)}")
    if rows is None or not skip:
        return native.int_array(geom + (0, 0))
    return native.int_array(geom + launch_rows(index.layout, tuple(full_shape), tuple(rows)))


def _expand(tab, index, full_shape, rows, what):
    """Launch K1 (K1r with ``rows``) on the card; count it as ``what``."""
    _check_cuda(tab, index, (index.n_unique,), what)
    geom = _launch_geometry(index, full_shape, what, rows)
    B = 1 if tab.ndim == 1 else tab.shape[1]
    shape = full_shape if rows is None else _local_shape(full_shape, rows)
    out = torch.empty(tuple(shape) + tuple(tab.shape[1:]), dtype=tab.dtype, device=tab.device)
    err = native.lib().nt_expand_to_grid(
        tab.data_ptr(), index.idx.data_ptr(), out.data_ptr(), geom, B, native.stream_of(tab)
    )
    native.check(err, what)
    native.launches[what] += 1
    native.batched_launches[what] += B > 1
    return out


def expand_to_grid(tab, index: ExpandIndex, full_shape):
    """K1: ``(U,)`` or ``(U, B)`` table -> ``full_shape`` (+ ``(B,)``)."""
    if tab.device.type == "cpu":
        return expand_to_grid_plain(tab, index, full_shape)
    return _expand(tab, index, full_shape, None, "expand_to_grid")


def expand_to_grid_rows(tab, index: ExpandIndex, full_shape, rows):
    """K1r: ``(U,)`` or ``(U, B)`` table -> the rows ``rows = (lo, n)`` of
    the ``full_shape`` grid, ``(n,) + full_shape[1:]`` (+ ``(B,)``)."""
    if tab.device.type == "cpu":
        return expand_to_grid_rows_plain(tab, index, full_shape, rows)
    return _expand(tab, index, full_shape, tuple(rows), "expand_to_grid_rows")


def collapse_from_grid(cot, index: ExpandIndex, full_shape):
    """K2: ``full_shape`` (+ ``(B,)``) cotangent -> ``(U,)`` or ``(U, B)``."""
    if cot.device.type == "cpu":
        return collapse_from_grid_plain(cot, index, full_shape)
    return _collapse(cot, index, full_shape, None, "collapse_from_grid")


def collapse_from_grid_rows(cot, index: ExpandIndex, full_shape, rows):
    """K2r: the cotangent of the rows ``rows = (lo, n)`` of the
    ``full_shape`` grid (``(n,) + full_shape[1:]``, + ``(B,)``) -> this
    range's part of the table cotangent, ``(U,)`` or ``(U, B)``."""
    if cot.device.type == "cpu":
        return collapse_from_grid_rows_plain(cot, index, full_shape, rows)
    return _collapse(cot, index, full_shape, tuple(rows), "collapse_from_grid_rows")


def _collapse(cot, index, full_shape, rows, what):
    """Launch K2 (K2r with ``rows``) on the card; count it as ``what``."""
    shape = full_shape if rows is None else _local_shape(full_shape, rows)
    _check_cuda(cot, index, shape, what)
    t = None if rows is None else index.row_tables(full_shape, rows)
    geom = _launch_geometry(index, full_shape, what, rows, skip=t is not None and not t.dense)
    batch = tuple(cot.shape[len(full_shape) :])
    B = batch[0] if batch else 1
    folded = torch.empty((index.n_packed,) + batch, dtype=cot.dtype, device=cot.device)
    out = torch.empty((index.n_unique,) + batch, dtype=cot.dtype, device=cot.device)
    if t is None or t.dense:
        err = native.lib().nt_collapse_from_grid(
            cot.data_ptr(), folded.data_ptr(), index.perm.data_ptr(), index.offsets.data_ptr(),
            index.n_unique, LARGE_BIN, index.large_bins.data_ptr(), index.large_bins.numel(),
            out.data_ptr(), geom, B, native.stream_of(cot),
        )
    else:
        err = native.lib().nt_collapse_from_grid_rows(
            cot.data_ptr(), folded.data_ptr(), t.perm.data_ptr(), t.offsets.data_ptr(),
            t.bins.data_ptr(), t.n_bins, LARGE_BIN, t.large_bins.data_ptr(), t.large_bins.numel(),
            out.data_ptr(), index.n_unique, geom, B, native.stream_of(cot),
        )
    native.check(err, what)
    native.launches[what] += 1
    native.batched_launches[what] += B > 1
    return out
