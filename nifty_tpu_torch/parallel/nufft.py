"""The type-2 NUFFT of a row-sharded field and its exact adjoint
(counterpart of the JAX package's ``nufft2`` under ``position_sharding=``,
which GSPMD partitions like any other op).

Each rank holds rows ``[lo, lo + b)`` of the image (``b = n0 / p``) and
returns its share, ``M / p`` consecutive points, of the visibilities at
``M`` fixed coordinates.  The stages (:func:`nufft_stages`):

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
    fixed sparse matrix from the oversampled grid to the points (the
    coordinates are constants), cut once to the entries in the rank's
    column block (column indices wrapped mod ``n_os1``, so a point's taps
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

:class:`ShardedNufft` packages (a)-(e) as one autograd Function: linear,
so its jvp is itself; its ``torch.func.vmap`` rule carries a leading
sample batch through one exchange each way.  Only ``all_to_all``,
``reduce_scatter`` and ``all_gather`` move data; the oversampled grid is
never gathered whole on a rank.
"""

from __future__ import annotations

import weakref
from typing import NamedTuple

import numpy as np
import torch

from ..ops.gather_reduce import GatherReduce
from ..ops.nufft import _kb_apodization, _params
from . import collectives
from .fft import MeshAxis
from .multihost import host_local_slice

__all__ = ["NufftPlan", "ShardedNufft", "nufft_stages", "sharded_nufft2"]

_CDT = {torch.float32: torch.complex64, torch.float64: torch.complex128}


def _kb(u, m: int, beta: float):
    """The Kaiser-Bessel window at ``u`` (a float64 tensor), 0 outside |u| < m/2."""
    t = 1.0 - (2.0 * u / m) ** 2
    val = torch.special.i0(beta * torch.sqrt(torch.clamp(t, min=0.0)))
    return torch.where(t > 0.0, val, torch.zeros_like(val)) / float(np.i0(beta))


class _Taps(NamedTuple):
    """One rank's tap matrix, on a device: ``idx``/``wgt`` ``(k, width)``
    per touched point (``points``, int64) over the block's cells; the
    transpose's CSR form: the entries sorted by cell, their points
    (``t_points``, indices into the whole) and weights, the run lengths and
    the hit cells (``t_cells``)."""

    idx: torch.Tensor
    wgt: torch.Tensor
    points: torch.Tensor
    t_points: torch.Tensor
    t_wgt: torch.Tensor
    t_lengths: torch.Tensor
    t_cells: torch.Tensor
    n_cells: int
    n_points: int

    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self[:7])


class NufftPlan:
    """The geometry of the sharded NUFFT of a ``shape`` image at ``coords``
    (numpy ``(ndim, M)``, in the coordinates' own float type) over ``p``
    ranks, and the ranks' tap matrices, each cut at first use on the device
    it serves (torch: the sort of every tap by cell is the card's) and kept
    per device and dtype."""

    def __init__(self, shape, coords, p: int, oversampling: float = 2.0, kernel_width: int = 6):
        self.shape = tuple(int(n) for n in shape)
        ndim = len(self.shape)
        if ndim < 2:
            raise ValueError("the sharded NUFFT takes an image of ndim >= 2 (rows and columns)")
        coords = np.asarray(coords)
        if coords.shape[0] != ndim:
            raise ValueError("coords must be (ndim, M)")
        self.p, self.m, self.n_points = int(p), int(kernel_width), int(coords.shape[1])
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

    def _entries(self, device):
        """Every tap of every point, on ``device``: ``(k1, h, w, order,
        sorted_h)``.  ``k1`` is each point's ``m`` columns of axis 1 (mod
        ``n_os1``); ``h`` and ``w`` are ``(M, m^ndim)`` in
        ``itertools.product``'s order: the tap's cell as ``k1 · (n_os0 ·
        trail) + k0 · trail + rest`` (axis 1 outermost, so a rank's column
        block is a range of it) and its weight (float64); ``order`` the flat
        taps of non-zero weight sorted by cell (stable: points ascending
        within a cell), ``sorted_h`` their cells.  The arithmetic of
        ``ops.nufft._taps``: nu in the coordinates' float type, the window in
        float64.  Made anew for each rank's taps (a sort on the card), so a
        rank keeps only its own tables."""
        M, m, n_os = self.n_points, self.m, self.n_os
        coords = torch.as_tensor(self._coords, device=device)
        offs = torch.arange(-(m // 2) + 1, m // 2 + 1, device=device)
        trail = int(np.prod(n_os[2:], dtype=np.int64))
        strides = [trail, n_os[0] * trail] + [int(np.prod(n_os[a + 1:], dtype=np.int64))
                                              for a in range(2, len(n_os))]
        h = torch.zeros((M, 1), dtype=torch.int64, device=device)
        w = torch.ones((M, 1), dtype=torch.float64, device=device)
        k1 = None
        for d, (no, stride) in enumerate(zip(n_os, strides)):
            nu = coords[d] * no
            k = torch.floor(nu).long()[:, None] + offs
            wd = _kb(nu.double()[:, None] - k, m, self.beta)
            k = torch.remainder(k, no)
            if d == 1:
                k1 = k
            h = (h[:, :, None] + k[:, None, :] * stride).reshape(M, -1)
            w = (w[:, :, None] * wd[:, None, :]).reshape(M, -1)
        nz = torch.nonzero(w.reshape(-1)).squeeze(1)
        sorted_h, perm = torch.sort(h.reshape(-1)[nz], stable=True)
        return k1, h, w, nz[perm], sorted_h

    def taps(self, rank: int, device, dtype) -> _Taps:
        """Rank ``rank``'s tap matrix on ``device``, weights in ``dtype``: the
        block's padded per-point tables over the points it touches, and the
        CSR transpose (a range of every tap sorted by cell); built at the
        first call from :meth:`_entries` and kept."""
        key = (rank, str(torch.device(device)), dtype)
        if key in self._taps:
            return self._taps[key]
        k1, h, w, order, sorted_h = self._entries(device)
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
        bounds = torch.tensor([c_lo * col, c_hi * col], device=sorted_h.device)
        a, b = (int(v) for v in torch.searchsorted(sorted_h, bounds))
        cells, taps = sorted_h[a:b], order[a:b]
        starts = torch.nonzero(torch.diff(cells, prepend=cells.new_full((1,), -1))).squeeze(1)
        lengths = torch.diff(starts, append=starts.new_full((1,), cells.numel()))
        self._taps[key] = _Taps(idx, wgt, touched, taps // T, w.reshape(-1)[taps].to(dtype), lengths,
                                local(cells[starts]), col * w_cols, self.n_points)
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

    def cols(self, chunks, rank: int):
        """(c)-(d): the chunks rank ``rank`` received (in the senders' order)
        -> its partial output over every point, ``(B, M)``."""
        blk = torch.fft.fft(self._embed(torch.cat(chunks, dim=1), 1, self.n_os[0]), dim=1)
        t = self.taps(rank, blk.device, blk.real.dtype)
        vals = GatherReduce.forward(blk.reshape(blk.shape[0], -1), t)
        return vals.new_zeros((blk.shape[0], self.n_points)).index_copy_(1, t.points, vals)

    def cols_t(self, g, rank: int):
        """(e), rank ``rank``'s part: the whole cotangent ``g`` (``(B, M)``) ->
        the chunk for each rank (its rows of this column block)."""
        t = self.taps(rank, g.device, g.real.dtype)
        B = g.shape[0]
        terms = torch.view_as_real(g[:, t.t_points] * t.t_wgt).movedim(1, 0)  # (entries, B, 2)
        sums = torch.segment_reduce(terms, "sum", lengths=t.t_lengths, axis=0)
        grid = g.new_zeros((B, t.n_cells)).index_copy_(
            1, t.t_cells, torch.view_as_complex(sums.movedim(0, 1).contiguous()))
        w_cols = self.bounds[rank + 1] - self.bounds[rank]
        G = grid.reshape((B, self.n_os[0], w_cols) + self.n_os[2:])
        G = self._crop(torch.fft.ifft(G, dim=1, norm="forward"), 1, self.shape[0])
        return list(G.split(self.b, dim=1))

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


def _forward(x, plan: NufftPlan, ax: MeshAxis, nd: int):
    batch = tuple(x.shape[: x.ndim - nd])
    xb = x.reshape((-1,) + tuple(x.shape[x.ndim - nd:]))
    sent = plan.rows(xb, ax.rank)
    got = collectives.all_to_all(sent, [tuple(sent[ax.rank].shape)] * ax.size, ax.group)
    part = plan.cols(got, ax.rank)
    out = collectives._reduce_scatter(part, 1, ax.group)
    return out.reshape(batch + (out.shape[-1],))


def _adjoint(g, plan: NufftPlan, ax: MeshAxis, nd: int, real: bool):
    batch = tuple(g.shape[:-1])
    gb = collectives._all_gather(g.reshape(-1, g.shape[-1]), 1, ax.group)
    sent = plan.cols_t(gb, ax.rank)
    w = [plan.bounds[s + 1] - plan.bounds[s] for s in range(ax.size)]
    shapes = [tuple(sent[0].shape[:2]) + (w[s],) + tuple(sent[0].shape[3:]) for s in range(ax.size)]
    got = collectives.all_to_all(sent, shapes, ax.group)
    out = plan.rows_t(got, ax.rank, real)
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


_PLANS: dict = {}  # id of a coordinate tensor -> (a weak reference to it, its plan's key, the plan)


def _plan_for(coords, shape, p, oversampling, kernel_width) -> NufftPlan:
    """The plan of ``coords`` (a tensor), kept while the tensor lives (one
    geometry a coordinate tensor at a time)."""
    key = (tuple(shape), int(p), float(oversampling), int(kernel_width), coords._version)
    entry = _PLANS.get(id(coords))
    if entry is None or entry[0]() is not coords or entry[1] != key:
        if entry is None or entry[0]() is not coords:
            weakref.finalize(coords, _PLANS.pop, id(coords), None)
        plan = nufft_stages(shape, coords, p, oversampling=oversampling, kernel_width=kernel_width)
        entry = _PLANS[id(coords)] = (weakref.ref(coords), key, plan)
    return entry[2]


def _refuse(what):
    raise NotImplementedError(
        f"position_sharding= takes the type-2 NUFFT of the row-sharded field at fixed "
        f"coordinates; {what} is not ported (ROADMAP.md)")


def sharded_nufft2(x, coords, ctx, *, oversampling: float = 2.0, kernel_width: int = 6):
    """``nufft2`` of the rank's rows ``x`` of a row-sharded image inside the
    field context ``ctx``: the rank's share of the visibilities at the
    fixed ``coords`` (``(ndim, M)``, ``M`` a multiple of the ranks),
    noted as a split output."""
    import torch.distributed as dist

    if coords.requires_grad or torch._C._functorch.is_functorch_wrapped_tensor(coords):
        _refuse("a NUFFT whose coordinates are inputs (VariablePositionNufft, "
                "ShiftedPositionFFT)")
    p, r = dist.get_world_size(ctx.group), dist.get_rank(ctx.group)
    if coords.shape[1] % p:
        _refuse(f"a NUFFT whose points do not split over the ranks ({coords.shape[1]} points "
                f"over {p} ranks)")
    shape = (x.shape[0] * p,) + tuple(x.shape[1:])
    plan = _plan_for(coords, shape, p, oversampling, kernel_width)
    out = ShardedNufft.apply(x, plan, MeshAxis(ctx.group, p, r), len(shape))
    return collectives.note_split(out)
