"""The type-2 NUFFT of a row-sharded field and its exact adjoint
(counterpart of the JAX package's ``nufft2`` under ``position_sharding=``,
which GSPMD partitions like any other op).

Each rank holds rows ``[lo, lo + b)`` of the image (``b = n0 / p``) and
returns its share of the visibilities at ``M`` coordinates: consecutive
points, ``np.array_split``'s blocks (the first ``M mod p`` ranks one
more; :func:`~.collectives.share`).  The stages (:func:`nufft_stages`):

(a) rows: deapodize the rank's rows (the row factors at ``lo .. lo + b -
    1``, the other axes' whole), embed each row centred in ``n_os1``
    columns (and the trailing axes in theirs) and take the FFT along axis 1
    and the trailing axes; cut the ``n_os1`` spectrum columns into the
    ``p`` ranks' blocks.  Every step is local;
(b) one exchange (``all_to_all``): rank ``s`` receives block ``s`` of
    every rank's rows, so it holds all ``n0`` image rows of its column
    block.  The zero rows of the oversampled frame are never sent: the
    padding of axis 0 happens after the exchange;
(c) columns: embed centred in ``n_os0`` rows and take the FFT along axis
    0: the rank's column block of the oversampled spectrum, ``(n_os0,
    n_os1 / p, ...)``.  No second exchange;
(d) taps: the ``kernel_width^ndim`` Kaiser-Bessel taps of each point are a
    sparse matrix from the oversampled grid to the points, cut once for
    each set of coordinates to the entries in the rank's column block (column indices wrapped mod ``n_os1``, so a point's taps
    may straddle the seam between the last rank and the first).  The cut
    runs in torch on the rank's device: it sorts every tap by cell (3.8e7
    of them at 2^20 points, seconds for numpy's sort on one CPU core).  The
    block's rows are applied by the gather-reduce of
    :class:`~..ops.gather_reduce.GatherReduce` (complex inputs, real
    weights) over the points the block touches, written into the
    full-length partial output; ``reduce_scatter`` sums the partials and
    keeps the rank's share;
(e) the pull-back, the exact adjoint: ``all_gather`` of the cotangent,
    the taps' transpose, the adjoint of the unnormalised FFT along axis 0
    (``ifft(norm="forward")``) and the crop of rows, the exchange back, the
    adjoint along the trailing axes, the crop, the deapodization, and the
    real part for a real image.

The taps' transpose is deterministic without padding to the busiest cell
(a dense uv core would pad every cell to hundreds of points): the block's
entries are sorted by cell once in numpy, and the pull-back gathers the
cotangent along that order, weights it and sums each cell's run with
``torch.segment_reduce``, writing each hit cell once.  No float atomics
run, so a pull-back gives the same bits on every call.

:class:`ShardedNufft` packages (a)-(e) as one autograd Function at fixed
coordinates: linear, so its jvp is itself; its ``torch.func.vmap`` rule
carries a leading sample batch through one exchange each way.  Only
``all_to_all``, ``reduce_scatter`` and ``all_gather`` move data; the
oversampled grid is never gathered whole on a rank.  Its plan is kept
while the coordinate tensor lives.

Coordinates that carry a gradient (``VariablePositionNufft``, whose
coordinates are a model input, and ``ShiftedPositionFFT``) take the same
stages, cut in two: :class:`NufftBlock`, (a)-(c), linear in the image,
and :class:`NufftTaps`, (d) without its reduce-scatter, of the block and
the coordinates.  The taps' derivatives ``w'(ν − k)·n_os`` (a table
beside the weights, ``_Taps.dwgt``, cut with them) applied to the same
block give the partial output's derivative in each coordinate: the
coordinates' tangent enters the partial output, which the reduce-scatter
sums like the forward, and the coordinates' cotangent on a rank is its
partial sum over its column block (the whole cotangent all-gathered
first), which the caller sums over the ranks (``replicate`` of replicated
coordinates; the adjoint of ``all_gather`` of ``ShiftedPositionFFT``'s
rows).  Their plans are found by value (:class:`PlanCache`, held by the
model: within a metric apply or a CG solve the primal coordinates are
fixed, while each call makes them anew).  The fixed coordinates keep the
one Function: through ``NufftBlock`` and ``NufftTaps`` their metric
apply and MGVI iteration measured slower on the card (PERF.md §6),
the cost of the Functions' dispatch under the ``torch.func`` transforms.
"""

from __future__ import annotations

import functools
import weakref
from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import tracing
from ..ops.gather_reduce import GatherReduce
from ..ops.nufft import _kb_apodization, _params
from ..utils.tree import looped
from . import collectives
from .fft import MeshAxis
from .multihost import host_local_slice

__all__ = ["Geometry", "NufftBlock", "NufftPlan", "NufftTaps", "PlanCache", "ShardedNufft", "nufft_stages",
           "sharded_nufft2", "taps_cut"]

_CDT = {torch.float32: torch.complex64, torch.float64: torch.complex128}


def _kb(u, m: int, beta: float):
    """The Kaiser-Bessel window at ``u`` (a float64 tensor), 0 outside |u| < m/2."""
    t = 1.0 - (2.0 * u / m) ** 2
    val = torch.special.i0(beta * torch.sqrt(torch.clamp(t, min=0.0)))
    return torch.where(t > 0.0, val, torch.zeros_like(val)) / float(np.i0(beta))


def _kb_du(u, m: int, beta: float):
    """The window's derivative in ``u``: ``-4 β² u i1(z) / (m² z I0(β))`` at
    ``z = β √(1 - (2u/m)²)`` inside the window (``i1(z)/z → 1/2`` as z → 0),
    0 outside and on its edge, as autograd differentiates the masked
    window of ``ops.nufft``."""
    t = 1.0 - (2.0 * u / m) ** 2
    z = beta * torch.sqrt(torch.clamp(t, min=0.0))
    ratio = torch.where(z > 1e-8, torch.special.i1(z) / torch.clamp(z, min=1e-8), torch.full_like(z, 0.5))
    val = -4.0 * beta**2 * u * ratio / (m**2 * float(np.i0(beta)))
    return torch.where(t > 0.0, val, torch.zeros_like(val))


class _Taps(NamedTuple):
    """One rank's tap matrix, on a device: ``idx``/``wgt`` ``(k, width)``
    per touched point (``points``, int64) over the block's cells; the
    transpose's CSR form: the entries sorted by cell, their points
    (``t_points``, indices into the whole) and weights, the run lengths and
    the hit cells (``t_cells``); for coordinates that carry a gradient
    ``dwgt`` ``(ndim, k, width)``, each weight's derivative in each
    coordinate of its point."""

    idx: torch.Tensor
    wgt: torch.Tensor
    points: torch.Tensor
    t_points: torch.Tensor
    t_wgt: torch.Tensor
    t_lengths: torch.Tensor
    t_cells: torch.Tensor
    n_cells: int
    n_points: int
    dwgt: Optional[torch.Tensor] = None

    def nbytes(self) -> int:
        tables = list(self[:7]) + ([] if self.dwgt is None else [self.dwgt])
        return sum(t.numel() * t.element_size() for t in tables)


class NufftPlan:
    """The geometry of the sharded NUFFT of a ``shape`` image at ``coords``
    (``(ndim, M)``, numpy or a tensor, in the coordinates' own float type;
    None for the geometry alone) over ``p`` ranks, and the ranks' tap
    matrices, each cut at first use on the device it serves (torch: the
    sort of every tap by cell is the card's) and kept per device and
    dtype."""

    def __init__(self, shape, coords, p: int, oversampling: float = 2.0, kernel_width: int = 6):
        self.shape = tuple(int(n) for n in shape)
        ndim = len(self.shape)
        if ndim < 2:
            raise ValueError("the sharded NUFFT takes an image of ndim >= 2 (rows and columns)")
        if coords is not None and coords.shape[0] != ndim:
            raise ValueError("coords must be (ndim, M)")
        self.p, self.m = int(p), int(kernel_width)
        self.n_points = None if coords is None else int(coords.shape[1])
        if self.shape[0] % self.p:
            raise ValueError(f"the {self.shape[0]} rows of the image do not split over {p} ranks")
        self.n_os, self.beta = _params(self.shape, oversampling, self.m)
        self.b = self.shape[0] // self.p
        n1 = self.n_os[1]
        self.bounds = tuple(host_local_slice(n1, count=self.p, index=s)[0] for s in range(self.p)) + (n1,)
        # the window's transform at each axis' centred indices (float64 numpy)
        self.apod = [_kb_apodization((np.arange(n) - n // 2) / no, self.m, self.beta)
                     for n, no in zip(self.shape, self.n_os)]
        self._coords = coords
        self._taps, self._apod = {}, {}

    # -- the tap matrices ----------------------------------------------------------------

    def _entries(self, device, deriv: bool = False):
        """Every tap of every point, on ``device``: ``(k1, h, w, order,
        sorted_h, dw)``.  ``k1`` is each point's ``m`` columns of axis 1 (mod
        ``n_os1``); ``h`` and ``w`` are ``(M, m^ndim)`` in
        ``itertools.product``'s order: the tap's cell as ``k1 · (n_os0 ·
        trail) + k0 · trail + rest`` (axis 1 outermost, so a rank's column
        block is a range of it) and its weight (float64); ``order`` the flat
        taps of non-zero weight sorted by cell (stable: points ascending
        within a cell), ``sorted_h`` their cells; with ``deriv`` ``dw``, the
        weights' derivatives in each coordinate ``(ndim, M, m^ndim)``
        (``w'(ν_d − k_d) n_os_d`` times the other axes' windows), else None.
        The arithmetic of ``ops.nufft._taps``: nu in the coordinates' float
        type, the window in float64.  Made anew for each rank's taps (a
        sort on the card), so a rank keeps only its own tables."""
        M, m, n_os = self.n_points, self.m, self.n_os
        coords = torch.as_tensor(self._coords, device=device)
        offs = torch.arange(-(m // 2) + 1, m // 2 + 1, device=device)
        trail = int(np.prod(n_os[2:], dtype=np.int64))
        strides = [trail, n_os[0] * trail] + [int(np.prod(n_os[a + 1:], dtype=np.int64))
                                              for a in range(2, len(n_os))]
        h = torch.zeros((M, 1), dtype=torch.int64, device=device)
        w = torch.ones((M, 1), dtype=torch.float64, device=device)
        dw = [w] * len(n_os) if deriv else []
        k1 = None
        for d, (no, stride) in enumerate(zip(n_os, strides)):
            nu = coords[d] * no
            k = torch.floor(nu).long()[:, None] + offs
            u = nu.double()[:, None] - k
            wd = _kb(u, m, self.beta)
            k = torch.remainder(k, no)
            if d == 1:
                k1 = k
            h = (h[:, :, None] + k[:, None, :] * stride).reshape(M, -1)
            w = (w[:, :, None] * wd[:, None, :]).reshape(M, -1)
            if deriv:
                dwd = _kb_du(u, m, self.beta) * no
                dw = [(f[:, :, None] * (dwd if e == d else wd)[:, None, :]).reshape(M, -1)
                      for e, f in enumerate(dw)]
        nz = torch.nonzero(w.reshape(-1)).squeeze(1)
        sorted_h, perm = torch.sort(h.reshape(-1)[nz], stable=True)
        return k1, h, w, nz[perm], sorted_h, torch.stack(dw) if deriv else None

    def taps(self, rank: int, device, dtype, deriv: bool = False) -> _Taps:
        """Rank ``rank``'s tap matrix on ``device``, weights in ``dtype``: the
        block's padded per-point tables over the points it touches, and the
        CSR transpose (a range of every tap sorted by cell); with ``deriv``
        the weights' derivatives too; built at the first call from
        :meth:`_entries` and kept."""
        key = (rank, str(torch.device(device)), dtype)
        if key in self._taps and (self._taps[key].dwgt is not None or not deriv):
            return self._taps[key]
        tracing.count("taps_cut")
        k1, h, w, order, sorted_h, dw = self._entries(device, deriv)
        T = h.shape[1]
        c_lo, c_hi = self.bounds[rank], self.bounds[rank + 1]
        w_cols = c_hi - c_lo
        trail = int(np.prod(self.n_os[2:], dtype=np.int64))
        col = self.n_os[0] * trail  # the cells of one column of axis 1

        def local(hh):  # a cell's index in the block's (n_os0, w_cols, trail) layout
            return (hh % col) // trail * (w_cols * trail) + (hh // col - c_lo) * trail + hh % trail

        touched = torch.nonzero(((k1 >= c_lo) & (k1 < c_hi)).any(dim=1)).squeeze(1)
        hs, ws = h[touched], w[touched]
        inside = (hs >= c_lo * col) & (hs < c_hi * col) & (ws != 0)
        counts = inside.sum(dim=1)
        r, c = torch.nonzero(inside, as_tuple=True)  # each point's taps in their order
        slot = torch.arange(r.numel(), device=r.device) - (torch.cumsum(counts, 0) - counts)[r]
        width = max(int(counts.max()) if counts.numel() else 0, 1)
        idx = torch.zeros((touched.numel(), width), dtype=torch.int64, device=r.device)
        wgt = torch.zeros((touched.numel(), width), dtype=dtype, device=r.device)
        idx[r, slot] = local(hs[r, c])
        wgt[r, slot] = ws[r, c].to(dtype)
        dwgt = None
        if deriv:
            dwgt = torch.zeros((len(self.n_os),) + tuple(wgt.shape), dtype=dtype, device=r.device)
            dwgt[:, r, slot] = dw[:, touched][:, r, c].to(dtype)
        bounds = torch.tensor([c_lo * col, c_hi * col], device=sorted_h.device)
        a, b = (int(v) for v in torch.searchsorted(sorted_h, bounds))
        cells, taps = sorted_h[a:b], order[a:b]
        starts = torch.nonzero(torch.diff(cells, prepend=cells.new_full((1,), -1))).squeeze(1)
        lengths = torch.diff(starts, append=starts.new_full((1,), cells.numel()))
        self._taps[key] = _Taps(idx, wgt, touched, taps // T, w.reshape(-1)[taps].to(dtype), lengths,
                                local(cells[starts]), col * w_cols, self.n_points, dwgt)
        return self._taps[key]

    def table_bytes(self) -> int:
        """The bytes of the tap matrices built so far."""
        return sum(t.nbytes() for t in self._taps.values())

    # -- the stages ------------------------------------------------------------------------

    def _deapodize(self, x, lo: int):
        """``x`` (a batch, then the rank's rows) divided by the window's
        apodization: the row factors at ``lo ..``, the other axes' whole."""
        real = x.real.dtype if x.is_complex() else x.dtype
        key = (str(x.device), real)
        if key not in self._apod:  # on the device once, so a call makes no host copy
            self._apod[key] = [torch.as_tensor(c, device=x.device, dtype=real) for c in self.apod]
        nd = len(self.shape)
        for a, corr in enumerate(self._apod[key]):
            c = corr[lo: lo + x.shape[1]] if a == 0 else corr
            shape = [1] * (nd + 1)
            shape[a + 1] = c.numel()
            x = x / c.reshape(shape)
        return x

    @staticmethod
    def _embed(x, dim: int, n_os: int):
        """``x`` embedded centred along ``dim`` in ``n_os``: index ``j`` at
        ``(j - n//2) mod n_os``."""
        n = x.shape[dim]
        h = n // 2
        zeros = x.new_zeros(x.shape[:dim] + (n_os - n,) + x.shape[dim + 1:])
        return torch.cat([x.narrow(dim, h, n - h), zeros, x.narrow(dim, 0, h)], dim=dim)

    @staticmethod
    def _crop(x, dim: int, n: int):
        """The adjoint of :meth:`_embed` along ``dim``: the ``n`` entries back."""
        h = n // 2
        n_os = x.shape[dim]
        return torch.cat([x.narrow(dim, n_os - h, h), x.narrow(dim, 0, n - h)], dim=dim)

    def rows(self, x, rank: int):
        """(a): the rank's rows ``x`` (``(B, b, ...)``) -> the chunk for each
        rank (its column block of the rows' spectra)."""
        nd = len(self.shape)
        x = self._deapodize(x, rank * self.b)
        if not x.is_complex():
            x = x.to(_CDT[x.dtype])
        for a in range(1, nd):
            x = self._embed(x, a + 1, self.n_os[a])
        x = torch.fft.fftn(x, dim=tuple(range(2, nd + 1)))
        c = self.bounds
        return [x[:, :, c[s]: c[s + 1]] for s in range(self.p)]

    def block(self, chunks):
        """(c): the chunks a rank received (in the senders' order) -> its
        column block of the oversampled spectrum, raveled: ``(B, cells)``."""
        blk = torch.fft.fft(self._embed(torch.cat(chunks, dim=1), 1, self.n_os[0]), dim=1)
        return blk.reshape(blk.shape[0], -1)

    def apply_taps(self, blk, rank: int):
        """(d) without the reduce-scatter: rank ``rank``'s raveled block ->
        its partial output over every point, ``(B, M)``."""
        t = self.taps(rank, blk.device, blk.real.dtype)
        vals = GatherReduce.forward(blk, t)
        return vals.new_zeros((blk.shape[0], self.n_points)).index_copy_(1, t.points, vals)

    def cols(self, chunks, rank: int):
        """(c)-(d): the chunks rank ``rank`` received (in the senders' order)
        -> its partial output over every point, ``(B, M)``."""
        return self.apply_taps(self.block(chunks), rank)

    def taps_t(self, g, rank: int):
        """The adjoint of :meth:`apply_taps`: the whole cotangent ``g``
        (``(B, M)``) -> rank ``rank``'s raveled block, each hit cell written
        once by the CSR segment sum."""
        t = self.taps(rank, g.device, g.real.dtype)
        terms = torch.view_as_real(g[:, t.t_points] * t.t_wgt).movedim(1, 0)  # (entries, B, 2)
        sums = torch.segment_reduce(terms, "sum", lengths=t.t_lengths, axis=0)
        return g.new_zeros((g.shape[0], t.n_cells)).index_copy_(
            1, t.t_cells, torch.view_as_complex(sums.movedim(0, 1).contiguous()))

    def block_t(self, grid, rank: int):
        """The adjoint of :meth:`block`: rank ``rank``'s raveled block
        cotangent -> the chunk for each rank (its rows of this column
        block)."""
        w_cols = self.bounds[rank + 1] - self.bounds[rank]
        G = grid.reshape((grid.shape[0], self.n_os[0], w_cols) + self.n_os[2:])
        G = self._crop(torch.fft.ifft(G, dim=1, norm="forward"), 1, self.shape[0])
        return list(G.split(self.b, dim=1))

    def cols_t(self, g, rank: int):
        """(e), rank ``rank``'s part: the whole cotangent ``g`` (``(B, M)``) ->
        the chunk for each rank (its rows of this column block)."""
        return self.block_t(self.taps_t(g, rank), rank)

    def rows_t(self, chunks, rank: int, real: bool):
        """(e), the rest: the chunks rank ``rank`` received -> the
        cotangent of its rows (real for a real image)."""
        nd = len(self.shape)
        x = torch.cat(chunks, dim=2)
        x = torch.fft.ifftn(x, dim=tuple(range(2, nd + 1)), norm="forward")
        for a in range(1, nd):
            x = self._crop(x, a + 1, self.shape[a])
        x = self._deapodize(x, rank * self.b)
        return x.real.contiguous() if real else x


def nufft_stages(shape, coords, p: int, *, oversampling: float = 2.0,
                 kernel_width: int = 6) -> NufftPlan:
    """The per-rank stages of the sharded NUFFT of a ``shape`` image at
    ``coords`` (``(ndim, M)``, a tensor or numpy) over ``p`` ranks: the
    plan's ``rows(x, rank)``, ``cols(chunks, rank)`` (a partial output;
    the ranks' partials add up to the whole ``nufft2``), ``cols_t(g,
    rank)`` and ``rows_t(chunks, rank, real)`` (the pull-back), for tests
    that compose them over virtual ranks in one process."""
    if isinstance(coords, torch.Tensor):
        with torch._C._DisableFuncTorch():  # a constant read inside torch.func transforms
            coords = coords.detach().cpu().numpy()
    return NufftPlan(shape, coords, p, oversampling, kernel_width)


def _block(x, plan: NufftPlan, ax: MeshAxis, nd: int):
    """(a)-(c) on the rank's rows ``x`` (a batch, then the rows): its
    raveled column block ``(B, cells)``."""
    sent = plan.rows(x.reshape((-1,) + tuple(x.shape[x.ndim - nd:])), ax.rank)
    return plan.block(collectives.all_to_all(sent, [tuple(sent[ax.rank].shape)] * ax.size, ax.group))


def _block_t(grid, plan: NufftPlan, ax: MeshAxis, real: bool):
    """The adjoint of :func:`_block`: the block's cotangent ``(B, cells)``
    -> the cotangent of the rank's rows ``(B, b, ...)``."""
    sent = plan.block_t(grid, ax.rank)
    w = [plan.bounds[s + 1] - plan.bounds[s] for s in range(ax.size)]
    shapes = [tuple(sent[0].shape[:2]) + (w[s],) + tuple(sent[0].shape[3:]) for s in range(ax.size)]
    return plan.rows_t(collectives.all_to_all(sent, shapes, ax.group), ax.rank, real)


def _forward(x, plan: NufftPlan, ax: MeshAxis, nd: int):
    batch = tuple(x.shape[: x.ndim - nd])
    part = plan.apply_taps(_block(x, plan, ax, nd), ax.rank)
    out = collectives._reduce_scatter(part, 1, ax.group)
    return out.reshape(batch + (out.shape[-1],))


def _adjoint(g, plan: NufftPlan, ax: MeshAxis, nd: int, real: bool):
    batch = tuple(g.shape[:-1])
    gb = collectives._all_gather(g.reshape(-1, g.shape[-1]), 1, ax.group, plan.n_points)
    out = _block_t(plan.taps_t(gb, ax.rank), plan, ax, real)
    return out.reshape(batch + tuple(out.shape[1:]))


class ShardedNufft(torch.autograd.Function):
    """The type-2 NUFFT of a row-sharded image (its ``nd`` trailing axes the
    rank's rows, leading axes a batch) to the rank's share of the points:
    linear, so its jvp is itself and its backward :class:`ShardedNufftT`;
    under ``torch.func.vmap`` the mapped axis joins the batch (one exchange
    each way for the whole batch)."""

    @staticmethod
    def forward(x, plan, ax, nd):
        return _forward(x, plan, ax, nd)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.plan, ctx.ax, ctx.nd = inputs[1:]
        ctx.real = not inputs[0].is_complex()

    @staticmethod
    def backward(ctx, grad):
        return ShardedNufftT.apply(grad, ctx.plan, ctx.ax, ctx.nd, ctx.real), None, None, None

    @staticmethod
    def jvp(ctx, tangent, *_):
        return ShardedNufft.apply(tangent, ctx.plan, ctx.ax, ctx.nd)

    @staticmethod
    def vmap(info, in_dims, x, plan, ax, nd):
        return ShardedNufft.apply(x.movedim(in_dims[0], 0), plan, ax, nd), 0


class ShardedNufftT(torch.autograd.Function):
    """The adjoint of :class:`ShardedNufft`: the rank's share of a
    cotangent to the cotangent of its rows (the real part for a real
    image)."""

    @staticmethod
    def forward(g, plan, ax, nd, real):
        return _adjoint(g, plan, ax, nd, real)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.plan, ctx.ax, ctx.nd, ctx.real = inputs[1:]

    @staticmethod
    def backward(ctx, grad):
        return ShardedNufft.apply(grad, ctx.plan, ctx.ax, ctx.nd), None, None, None, None

    @staticmethod
    def jvp(ctx, tangent, *_):
        return ShardedNufftT.apply(tangent, ctx.plan, ctx.ax, ctx.nd, ctx.real)

    @staticmethod
    def vmap(info, in_dims, g, plan, ax, nd, real):
        return ShardedNufftT.apply(g.movedim(in_dims[0], 0), plan, ax, nd, real), 0


# --- coordinates that carry a gradient ------------------------------------------------------


class NufftBlock(torch.autograd.Function):
    """(a)-(c): the rank's rows of the image (a batch, then ``nd`` axes)
    -> its raveled column block of the oversampled spectrum (the batch,
    then the block's cells).  Linear; its backward is :class:`NufftBlockT`."""

    @staticmethod
    def forward(x, plan, ax, nd):
        blk = _block(x, plan, ax, nd)
        return blk.reshape(tuple(x.shape[: x.ndim - nd]) + (blk.shape[-1],))

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.plan, ctx.ax, ctx.nd = inputs[1:]
        ctx.real = not inputs[0].is_complex()

    @staticmethod
    def backward(ctx, grad):
        return NufftBlockT.apply(grad, ctx.plan, ctx.ax, ctx.nd, ctx.real), None, None, None

    @staticmethod
    def jvp(ctx, tangent, *_):
        return NufftBlock.apply(tangent, ctx.plan, ctx.ax, ctx.nd)

    @staticmethod
    def vmap(info, in_dims, x, plan, ax, nd):
        return NufftBlock.apply(x.movedim(in_dims[0], 0), plan, ax, nd), 0


class NufftBlockT(torch.autograd.Function):
    """The adjoint of :class:`NufftBlock`: a block's cotangent -> the
    cotangent of the rank's rows (real for a real image)."""

    @staticmethod
    def forward(grid, plan, ax, nd, real):
        batch = tuple(grid.shape[:-1])
        out = _block_t(grid.reshape(-1, grid.shape[-1]), plan, ax, real)
        return out.reshape(batch + tuple(out.shape[1:]))

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.plan, ctx.ax, ctx.nd, ctx.real = inputs[1:]

    @staticmethod
    def backward(ctx, grad):
        return NufftBlock.apply(grad, ctx.plan, ctx.ax, ctx.nd), None, None, None, None

    @staticmethod
    def jvp(ctx, tangent, *_):
        return NufftBlockT.apply(tangent, ctx.plan, ctx.ax, ctx.nd, ctx.real)

    @staticmethod
    def vmap(info, in_dims, grid, plan, ax, nd, real):
        return NufftBlockT.apply(grid.movedim(in_dims[0], 0), plan, ax, nd, real), 0


def _deriv_taps(blk, t, batch):
    """``G[d]``: the derivative taps of each coordinate axis ``d`` applied
    to the block ``blk`` (its batch, then the cells; its batch the trailing
    axes of ``batch`` or none), broadcast to ``batch`` and raveled:
    ``(ndim, prod(batch), k)`` over the touched points.  A block shared by
    the batch is gathered once."""
    own = tuple(blk.shape[:-1])
    G = torch.stack([GatherReduce.forward(blk.reshape(-1, blk.shape[-1]), t._replace(wgt=dw))
                     for dw in t.dwgt])
    G = G.reshape((G.shape[0],) + (1,) * (len(batch) - len(own)) + own + (G.shape[-1],))
    return G.expand((G.shape[0],) + tuple(batch) + (G.shape[-1],)).reshape(G.shape[0], -1, G.shape[-1])


def _taps_value(blk, coords, plans, rank):
    """:class:`NufftTaps`'s value on plain tensors: ``blk`` (a batch, then
    the cells), ``coords`` ``(ndim, M)``; the coordinates' first cut has
    the derivative taps too, which the jvp or the backward reads next."""
    plan = plans.plan(coords)
    plan.taps(rank, blk.device, blk.real.dtype, deriv=True)
    out = plan.apply_taps(blk.reshape(-1, blk.shape[-1]), rank)
    return out.reshape(tuple(blk.shape[:-1]) + (plan.n_points,))


def _taps_tangent(dblk, dc, blk, coords, plans, rank):
    """The partial output's tangent at ``(blk, coords)`` (plain tensors;
    ``blk`` a batch, then the cells, shared by the tangents' batch where it
    has none): the taps of the block's tangent
    ``dblk`` (None: 0) plus each point's coordinates' tangent ``dc``
    (``(ndim, M)``, or with leading axes of the batch's; None: 0) times the
    derivative taps of ``blk``."""
    plan = plans.plan(coords)
    bd = tuple(torch.broadcast_shapes(blk.shape[:-1], () if dblk is None else dblk.shape[:-1],
                                      () if dc is None else dc.shape[:-2]))
    n = int(np.prod(bd, dtype=np.int64))
    out = blk.new_zeros((n, plan.n_points))
    if dblk is not None:
        out = out + plan.apply_taps(dblk.reshape(n, -1), rank)
    if dc is not None:
        t = plan.taps(rank, blk.device, blk.real.dtype, deriv=True)
        G = _deriv_taps(blk, t, bd)  # (ndim, n, k)
        lead = tuple(dc.shape[:-2])
        dcb = dc.reshape(lead + (1,) * (len(bd) - len(lead)) + tuple(dc.shape[-2:]))
        dcb = dcb.expand(bd + tuple(dc.shape[-2:])).reshape((n,) + tuple(dc.shape[-2:]))
        vals = (dcb[:, :, t.points].movedim(1, 0).to(G.dtype) * G).sum(0)
        out = out + vals.new_zeros((n, plan.n_points)).index_copy_(1, t.points, vals)
    return out.reshape(bd + (plan.n_points,))


def _taps_cotangents(g, blk, coords, plans, rank, keep: int = 0):
    """The cotangents of ``(blk, coords)`` from the whole partial output's
    ``g`` (a batch, then ``M``; ``blk``'s batch its trailing axes or none):
    the taps' CSR transpose of ``g``, and each coordinate's partial sum over this
    rank's block, ``Re(conj(G) g)``, summed over the batch but its first
    ``keep`` axes."""
    plan = plans.plan(coords)
    bd = tuple(g.shape[:-1])
    gb = g.reshape(-1, g.shape[-1])
    d_blk = plan.taps_t(gb, rank).reshape(bd + (-1,))
    t = plan.taps(rank, blk.device, blk.real.dtype, deriv=True)
    G = _deriv_taps(blk, t, bd)
    vals = (G.conj() * gb[:, t.points]).real  # (ndim, batch, k)
    vals = vals.reshape((vals.shape[0], int(np.prod(bd[:keep], dtype=np.int64)), -1, vals.shape[-1])).sum(2)
    d_c = coords.new_zeros((vals.shape[1],) + tuple(coords.shape)).index_copy_(
        2, t.points, vals.movedim(0, 1).to(coords.dtype))
    return d_blk, d_c.reshape(bd[:keep] + tuple(coords.shape))


def _lead(a, d, n):
    """``a`` with its mapped axis ``d`` first (broadcast to ``n`` where it
    has none; None stays None)."""
    if a is None:
        return None
    return a.movedim(d, 0) if d is not None else a.unsqueeze(0).expand((n,) + tuple(a.shape))


def _per_sample(fn, args, in_dims, plans):
    """``fn`` of each sample of the mapped ``args`` (``in_dims`` None for
    an unmapped one), stacked on a leading axis: coordinates that differ by
    sample take each sample's taps, and ``plans`` keeps as many."""
    n = next(a.shape[d] for a, d in zip(args, in_dims) if d is not None)
    plans.keep(n)
    outs = [fn(*[a if d is None or a is None else a.select(d, i) for a, d in zip(args, in_dims)])
            for i in range(n)]
    if isinstance(outs[0], tuple):
        return tuple(torch.stack(o) for o in zip(*outs))
    return torch.stack(outs)


class _TapsTangent(torch.autograd.Function):
    """:func:`_taps_tangent` as a Function (the jvp of :class:`NufftTaps`),
    so a transform above it maps it by :meth:`vmap`."""

    @staticmethod
    def forward(dblk, dc, blk, coords, plans, rank):
        return _taps_tangent(dblk, dc, blk, coords, plans, rank)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, grad):
        raise NotImplementedError("the NUFFT's tangent in its coordinates is not differentiated again")

    @staticmethod
    def vmap(info, in_dims, dblk, dc, blk, coords, plans, rank):
        if in_dims[3] is None:  # one set of coordinates: the mapped axis leads the batch
            n = info.batch_size
            dc = dc if in_dims[1] is None else dc.movedim(in_dims[1], 0)
            blk = blk if in_dims[2] is None else blk.movedim(in_dims[2], 0)
            return _TapsTangent.apply(_lead(dblk, in_dims[0], n), dc, blk, coords, plans, rank), 0
        return _per_sample(lambda a, b, c, d: _TapsTangent.apply(a, b, c, d, plans, rank),
                           (dblk, dc, blk, coords), in_dims[:4], plans), 0


class _TapsCotangents(torch.autograd.Function):
    """:func:`_taps_cotangents` as a Function (the backward of
    :class:`NufftTaps`), mapped by :meth:`vmap`."""

    @staticmethod
    def forward(g, blk, coords, plans, rank, keep=0):
        return _taps_cotangents(g, blk, coords, plans, rank, keep)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError("the NUFFT's cotangent in its coordinates is not differentiated again")

    @staticmethod
    def vmap(info, in_dims, g, blk, coords, plans, rank, keep=0):
        if in_dims[2] is None:  # one set of coordinates: a cotangent a mapped sample
            n = info.batch_size
            blk = blk if in_dims[1] is None else blk.movedim(in_dims[1], 0)
            return _TapsCotangents.apply(_lead(g, in_dims[0], n), blk, coords, plans, rank, keep + 1), (0, 0)
        return _per_sample(lambda a, b, c: _TapsCotangents.apply(a, b, c, plans, rank, keep),
                           (g, blk, coords), in_dims[:3], plans), (0, 0)


class NufftTaps(torch.autograd.Function):
    """(d) without its reduce-scatter, for coordinates that carry a
    gradient: the rank's raveled block ``blk`` (a batch, then the cells)
    and the coordinates ``coords`` ``(ndim, M)`` -> the rank's partial
    output over every point (the batch, then ``M``).  The taps are those of
    the coordinates' values (``plans``, a :class:`PlanCache`); its jvp adds
    the derivative taps times the coordinates' tangent, its backward gives
    the block the taps' transpose and the coordinates their partial sum
    over the rank's block; under ``torch.func.vmap`` coordinates that
    differ by sample take each sample's taps."""

    @staticmethod
    def forward(blk, coords, plans, rank):
        return _taps_value(blk, coords, plans, rank)

    @staticmethod
    def setup_context(ctx, inputs, output):
        blk, coords, ctx.plans, ctx.rank = inputs
        ctx.save_for_backward(blk, coords)
        ctx.save_for_forward(blk, coords)

    @staticmethod
    def backward(ctx, grad):
        blk, coords = ctx.saved_tensors
        d_blk, d_c = _TapsCotangents.apply(grad, blk, coords, ctx.plans, ctx.rank)
        return d_blk, d_c, None, None

    @staticmethod
    def jvp(ctx, d_blk, d_c, *_):
        blk, coords = ctx.saved_tensors
        return _TapsTangent.apply(d_blk, d_c, blk, coords, ctx.plans, ctx.rank)

    @staticmethod
    def vmap(info, in_dims, blk, coords, plans, rank):
        if in_dims[1] is None:  # one set of coordinates: the mapped axis joins the block's batch
            return NufftTaps.apply(blk.movedim(in_dims[0], 0), coords, plans, rank), 0
        return _per_sample(lambda b, c: NufftTaps.apply(b, c, plans, rank), (blk, coords), in_dims[:2],
                           plans), 0


# --- plans -----------------------------------------------------------------------------------


class Geometry(NamedTuple):
    """What a plan is cut for besides its coordinates: the image's shape,
    the ranks, the oversampling and the kernel width."""

    shape: tuple
    p: int
    oversampling: float
    kernel_width: int

    def plan(self, coords=None) -> NufftPlan:
        """A new plan of ``coords`` (None: the geometry alone)."""
        return NufftPlan(self.shape, coords, self.p, self.oversampling, self.kernel_width)


_FIXED: dict = {}  # id of a coordinate tensor -> (a weak reference to it, its plan's key, the plan)


def _fixed_plan(coords, geo: Geometry) -> NufftPlan:
    """The plan of fixed coordinates (a tensor without a gradient) in
    ``geo``, found by the tensor itself and its ``_version`` and freed when
    the tensor is (one geometry a coordinate tensor at a time)."""
    key = (geo, coords._version)
    entry = _FIXED.get(id(coords))
    if entry is None or entry[0]() is not coords or entry[1] != key:
        if entry is None or entry[0]() is not coords:
            weakref.finalize(coords, _FIXED.pop, id(coords), None)
        entry = _FIXED[id(coords)] = (weakref.ref(coords), key, geo.plan(coords.detach().clone()))
    return entry[2]


class PlanCache:
    """The plans of coordinates that carry a gradient in ``geo``, found by
    their values: a model makes its coordinates anew at each call, while
    within a metric apply or a CG solve they stay fixed.  It keeps the
    most recently used, as many as the most coordinate sets one call has
    mapped (the samples of a KL under ``torch.func.vmap`` or in an
    :func:`~..utils.tree.lmap` loop; one at least), so a KL's metric
    applies cut no taps again.  The model
    that owns the coordinates holds its caches, so the plans go with it; a
    copy or a pickle starts empty."""

    def __init__(self, geo: Geometry):
        self.geo, self.kept, self._entries = geo, 1, []  # entries: (a copy of the coordinates, the plan)

    def __reduce__(self):
        return PlanCache, (self.geo,)

    def keep(self, n: int):
        """Keep at least ``n`` plans (``n`` coordinate sets in one call)."""
        self.kept = max(self.kept, int(n))

    def plan(self, coords) -> NufftPlan:
        self.keep(looped())  # a loop over samples asks for each sample's in turn
        with torch._C._DisableFuncTorch():  # the coordinates' values, inside torch.func transforms too
            c = coords.detach()
            hit = next((e for e in self._entries if e[0].shape == c.shape and e[0].dtype == c.dtype
                        and e[0].device == c.device and torch.equal(e[0], c)), None)
            if hit is None:
                copy = c.clone()
                hit = (copy, self.geo.plan(copy))
            self._entries = [e for e in self._entries if e is not hit] + [hit]
            del self._entries[:-self.kept]
        return hit[1]


def taps_cut() -> int:
    """The tap matrices this process has cut (one a rank and set of
    coordinates), for a caller that counts the cuts of a run: the counter
    ``tracing.counts["taps_cut"]``."""
    return tracing.counts["taps_cut"]


def sharded_nufft2(x, coords, ctx, *, oversampling: float = 2.0, kernel_width: int = 6,
                   local_coords: bool = False, plans: Optional[dict] = None):
    """``nufft2`` of the rank's rows ``x`` of a row-sharded image inside the
    field context ``ctx``: the rank's share of the visibilities at
    ``coords`` (``(ndim, M)``; ``np.array_split``'s block of the points),
    noted as a split output.  Coordinates that carry a gradient have their
    cotangent summed over the ranks (``replicate``: the coordinates are
    replicated) unless ``local_coords`` (the caller's coordinates are the
    rank's own copy, as an ``all_gather`` of split ones is, whose adjoint
    sums); their plans are kept in ``plans`` (a model's dict, geometry ->
    :class:`PlanCache`; None: this call's alone)."""
    import torch.distributed as dist

    p, r = dist.get_world_size(ctx.group), dist.get_rank(ctx.group)
    shape = (x.shape[0] * p,) + tuple(x.shape[1:])
    ax, nd = MeshAxis(ctx.group, p, r), len(shape)
    geo = Geometry(shape, p, float(oversampling), int(kernel_width))
    if not (coords.requires_grad or torch._C._functorch.is_functorch_wrapped_tensor(coords)):
        out = ShardedNufft.apply(x, _fixed_plan(coords, geo), ax, nd)
    else:
        if not local_coords:
            coords = collectives.replicate(coords, ctx.group)
        plans = {} if plans is None else plans
        cache = plans[geo] = plans.get(geo) or PlanCache(geo)
        blk = NufftBlock.apply(x, _geometry_plan(geo), ax, nd)
        out = collectives.reduce_scatter(NufftTaps.apply(blk, coords, cache, r), ctx.group, axis=-1)
    return collectives.note_split(out)


@functools.lru_cache(maxsize=None)
def _geometry_plan(geo: Geometry) -> NufftPlan:
    """The plan of ``geo`` without coordinates: stages (a)-(c) and their
    adjoints (the window's transforms, kept once on each device)."""
    return geo.plan()
