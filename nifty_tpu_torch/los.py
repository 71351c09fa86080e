"""Line-of-sight responses for tomography (counterpart of ``nifty_tpu/los.py``).

:class:`SamplingCartesianGridLOS` integrates a gridded field along
straight rays by sampling equidistant points with multilinear
:func:`~.ops.ndimage.map_coordinates` and summing: one gather a corner
over every point of every ray.

:class:`ExactGridLOS` is the exact traversal: the ray-cell intersection
segments are computed once with numpy (the reference's traversal and its
endpoint-uncertainty weighting, copied here) into padded per-ray ``(cell
index, weight)`` tables, and the apply is the weighted gather-reduce of
:class:`~.ops.gather_reduce.PaddedSparse`, whose transpose is a second
gather over a cell-major table: deterministic on the card.  The indices
are int64, so grids of 2³¹ cells and more are indexed right (the JAX
package's tables are int32); the weights are float32, as the reference's.

Both are field-aware: inside :func:`~.parallel.collectives.field_sharded`
their input is the rank's rows of a row-sharded field, and their output
the rank's share of the rays (``field_share``: ``np.array_split``'s
blocks, so any number of rays splits), so the likelihood's data
are that share (see :mod:`.parallel.collectives`).  The exact response
then applies the tables of the rank's cells, cut once per row range in
numpy (:func:`~.ops.gather_reduce.column_block` of the per-ray tables, a
slice of the cell-major ones) and kept, and reduce-scatters the partial
ray sums; the sampled one weights only the corners in the rank's rows and
reduce-scatters likewise.  A point outside the whole grid is NaN on every
rank, one outside the rank's rows adds 0.  Outside the context both act
on the whole grid.
"""

from __future__ import annotations

import numpy as np
import torch

from . import device as _device
from .model import LazyModel
from .ops.gather_reduce import PaddedSparse, RowBlocks, transpose_tables
from .ops.ndimage import map_coordinates
from .parallel import collectives
from .utils.tree import ShapeWithDtype

__all__ = ["ExactGridLOS", "SamplingCartesianGridLOS"]


def _share(target, p, rank):
    """The shape of rank ``rank``'s share of an output of shape ``target``
    split over ``p`` ranks along its leading axis (``np.array_split``'s
    blocks: the first ``target[0] mod p`` ranks one ray more)."""
    lo, hi = collectives.share(target[0], p, rank)
    return (hi - lo,) + tuple(target[1:])


def _field_aware(response, x):
    """``response`` applied to ``x``: the whole grid outside a field
    context; inside one, ``x`` the rank's rows, the ranks' partial outputs
    summed and this rank's share of them kept."""
    ctx = collectives.field()
    if ctx is None:
        return response.rows_partial(x)
    lo, _ = collectives.rank_rows(ctx.group, x.shape[0], response.domain.shape[0])
    out = collectives.reduce_scatter(response.rows_partial(x, lo), ctx.group)
    return collectives.note_split(out)


class SamplingCartesianGridLOS(LazyModel):
    """Line-of-sight integrals from ``start`` to ``end`` points (physical
    coordinates, ``(..., ndim)``) over a regular Cartesian grid of
    ``shape`` and ``distances``; either endpoint set may be one point
    shared by every ray.  ``n_sampling_points`` points a ray, interpolated
    at ``interpolation_order`` 0 or 1 with NaN outside the grid.  The
    endpoints live on ``device`` (the CUDA card by default) in ``dtype``."""

    def __init__(self, start, end, *, shape, distances, n_sampling_points: int = 500,
                 interpolation_order: int = 1, dtype=None, device=None):
        device = _device.resolve(device)
        fdt = dtype or torch.get_default_dtype()
        start, end = np.asarray(start, float), np.asarray(end, float)
        tgt_shape = (end if end.ndim >= start.ndim else start).shape[:-1]
        super().__init__(domain=ShapeWithDtype(tuple(shape), dtype),
                         target=ShapeWithDtype(tgt_shape, dtype))
        shape_arr = np.asarray(shape, dtype=float)
        l2i = ((shape_arr - 1.0) / shape_arr) / np.asarray(distances, dtype=float)
        for name, a in (("start", start), ("end", end), ("l2i", l2i)):
            self.register_buffer(name, torch.as_tensor(a, device=device, dtype=fdt))
        self.n_sampling_points = int(n_sampling_points)
        self.order = int(interpolation_order)

    def field_share(self, p: int, rank: int):
        """The shape of rank ``rank``'s share of the output over ``p`` ranks."""
        return _share(tuple(self.target.shape), p, rank)

    def rows_partial(self, x, lo=None):
        """Every ray's integral over the grid's rows ``[lo, lo + len(x))``,
        ``x`` those rows (over the whole grid for ``lo`` None)."""
        n = self.n_sampling_points
        start, end = torch.broadcast_tensors(self.start, self.end)
        si, ei = start * self.l2i, end * self.l2i
        t = torch.arange(n, device=si.device, dtype=si.dtype) + 0.5
        pts = si[..., None] + ((ei - si) / n)[..., None] * t  # (..., ndim, n)
        length = torch.linalg.vector_norm(end - start, dim=-1)
        rows = None if lo is None else (lo, self.domain.shape[0])
        vals = map_coordinates(x, pts.movedim(-2, 0), self.order, cval=float("nan"), rows=rows)
        return vals.sum(-1) * (length / n)

    def forward(self, x):
        return _field_aware(self, x)


# --- exact ray-cell traversal (the reference's LOSResponse) --------------------


def _gaussian_survival(x):
    from scipy.special import erfc

    return 0.5 * erfc(x / np.sqrt(2.0))


def _clip_to_box(p0, d, shp):
    """Entry/exit parameters of the segment p0 + t*d, t in [0,1], against
    the box [0, shp] per the reference's conventions (degenerate axes get
    pushed to ±1e12; the interval is shrunk by 1e-7 to dodge crossings
    exactly on cell boundaries)."""
    safe_d = np.where(d == 0.0, 1e-12, d)
    t_lo = np.where(d == 0.0, ((p0 > 0) - 0.5) * 1e12, -p0 / safe_d)
    t_hi = np.where(d == 0.0, ((p0 < shp) - 0.5) * -1e12, (shp - p0) / safe_d)
    tmin = max(0.0, np.minimum(t_lo, t_hi).max())
    tmax = min(1.0, np.maximum(t_lo, t_hi).min())
    tmax = max(tmin, tmax)
    return tmin + 1e-7, tmax - 1e-7


def _traverse_ray(p0, d, shp, strides):
    """All cell crossings of one ray (pixel coords): the sorted crossing
    parameters in (tmin, tmax), the flat index of the entry cell, and the
    per-crossing flat-index increments."""
    tmin, tmax = _clip_to_box(p0, d, np.asarray(shp, float))
    if tmin >= tmax:
        return None
    ts, steps = [], []
    for j, dj in enumerate(d):
        if dj == 0.0:
            continue
        # first integer coordinate crossed after tmin, then equidistant
        c0 = np.ceil(p0[j] + dj * tmin)
        if dj < 0.0:
            c0 -= 1.0
        t0 = (c0 - p0[j]) / dj
        tj = np.arange(t0, tmax, abs(1.0 / dj))
        ts.append(tj)
        steps.append(np.full(tj.size, strides[j] if dj > 0 else -strides[j], np.int64))
    ts = np.concatenate(ts) if ts else np.empty(0)
    steps = np.concatenate(steps) if steps else np.empty(0, np.int64)
    order = np.argsort(ts)
    entry_cell = int(np.sum(np.asarray(p0 + tmin * d, np.int64) * strides))
    return tmin, tmax, ts[order], entry_cell, steps[order]


def _ray_cells_and_weights(start, end, shape, distances, *, length, lo, hi, sigma, survival):
    """Exact traversal of one ray: (flat cell indices, segment weights).
    Weights are physical segment lengths, reweighted by the endpoint-
    uncertainty survival function on (lo, hi] and cut beyond hi."""
    shp = np.asarray(shape)
    strides = np.ones(len(shp), np.int64)
    for j in range(len(shp) - 2, -1, -1):
        strides[j] = strides[j + 1] * shp[j + 1]
    d = end - start
    tr = _traverse_ray(start, d, shp, strides)
    if tr is None:
        return np.empty(0, np.int64), np.empty(0)
    tmin, tmax, ts, entry_cell, steps = tr
    scale = np.linalg.norm(d * distances)
    bounds = np.concatenate(([tmin], ts, [tmax])) * scale
    wgt = np.diff(bounds)
    cells = entry_cell + np.concatenate(([0], np.cumsum(steps)))
    # endpoint uncertainty: segments past `hi` vanish; between `lo` and
    # `hi` the chance that the (inverse-Gaussian-distributed) endpoint
    # lies beyond the segment midpoint reweights it
    s_mid = 0.5 * (bounds[:-1] + bounds[1:])
    wgt = np.where(s_mid > hi, 0.0, wgt)
    tail = (s_mid > lo) & (s_mid <= hi)
    if np.any(tail):
        wgt = np.where(
            tail,
            wgt * survival((-1.0 / np.maximum(s_mid, 1e-300) + 1.0 / length) / sigma),
            wgt,
        )
    return cells, wgt


def los_tables(starts, ends, *, shape, distances, sigmas=None, truncation: float = 3.0):
    """The padded per-ray tables of the exact traversal, numpy: ``idx``
    (int64 flat cell indices) and ``wgt`` (float32 segment weights), each
    ``(n_los, width)``, zero-padded; ``starts``/``ends`` ``(n_los,
    ndim)`` physical coordinates, ``sigmas`` the endpoints' inverse-
    distance uncertainty a ray (or None), truncated at ``truncation``
    sigma."""
    starts = np.atleast_2d(np.asarray(starts, float))
    ends = np.atleast_2d(np.asarray(ends, float))
    if starts.shape != ends.shape:
        raise ValueError("starts/ends shape mismatch")
    n_los, ndim = starts.shape
    shape = tuple(int(s) for s in np.atleast_1d(shape))
    if len(shape) != ndim:
        raise ValueError("shape/ray dimension mismatch")
    distances = np.broadcast_to(np.atleast_1d(np.asarray(distances, float)), (ndim,))

    diffs = ends - starts
    lengths = np.linalg.norm(diffs, axis=1)
    if sigmas is None:
        sig = np.zeros(n_los)
        reach = lengths
        lo = hi = lengths  # no uncertainty band
    else:
        sig = np.asarray(sigmas, float)
        if sig.shape != (n_los,):
            raise ValueError("sigmas must have one entry per ray")
        inv = 1.0 / lengths
        if np.any(inv - truncation * sig <= 0):
            raise ValueError("truncation too high: negative maximum distances")
        reach = 1.0 / (inv - truncation * sig)
        lo = 1.0 / (inv + truncation * sig)
        hi = reach

    # pixel coordinates (reference convention: physical origin sits at
    # pixel coordinate +0.5)
    p_start = starts / distances + 0.5
    unit = diffs / np.where(lengths == 0.0, 1.0, lengths)[:, None]
    p_end = (starts + unit * reach[:, None]) / distances + 0.5

    per_ray = [
        _ray_cells_and_weights(p_start[i], p_end[i], shape, distances, length=lengths[i],
                               lo=lo[i], hi=hi[i], sigma=max(sig[i], 1e-300),
                               survival=_gaussian_survival)
        for i in range(n_los)
    ]
    width = max((c.size for c, _ in per_ray), default=1) or 1
    idx = np.zeros((n_los, width), np.int64)
    wgt = np.zeros((n_los, width), np.float32)
    for i, (c, w) in enumerate(per_ray):
        idx[i, : c.size] = c
        wgt[i, : w.size] = w
    return idx, wgt


class ExactGridLOS(LazyModel):
    """Exact line-of-sight response over a regular Cartesian grid (the
    reference's ``LOSResponse``): ``starts``/``ends`` are ``(n_los,
    ndim)`` physical coordinates; with ``sigmas`` the endpoint of each ray
    is uncertain with Gaussian inverse-distance error and the response is
    the expectation over endpoints, truncated at ``truncation`` sigma.
    The tables (:func:`los_tables`) live on ``device`` (the CUDA card by
    default), the weights in ``dtype``; ``table`` is the
    :class:`~.ops.gather_reduce.PaddedSparse` response matrix, and
    ``row_tables`` those of the row ranges a sharded run has applied
    (:meth:`rows_table`)."""

    def __init__(self, starts, ends, *, shape, distances, sigmas=None, truncation: float = 3.0,
                 dtype=None, device=None):
        idx, wgt = los_tables(starts, ends, shape=shape, distances=distances, sigmas=sigmas,
                              truncation=truncation)
        shape = tuple(int(s) for s in np.atleast_1d(shape))
        super().__init__(domain=ShapeWithDtype(shape, dtype),
                         target=ShapeWithDtype((idx.shape[0],), dtype))
        t_tables = transpose_tables(idx, wgt)
        self.table = PaddedSparse(idx, wgt, int(np.prod(shape)), device=device, dtype=dtype,
                                  transpose=t_tables)
        self.row_tables = RowBlocks(idx, wgt, t_tables, shape)

    def field_share(self, p: int, rank: int):
        """The shape of rank ``rank``'s share of the rays over ``p`` ranks."""
        return _share(tuple(self.target.shape), p, rank)

    def rows_table(self, lo: int, n: int) -> PaddedSparse:
        """The response of the grid's rows ``[lo, lo + n)``: every ray's
        segments in those rows, over their cells; cut in numpy at the first
        call and kept (``row_tables``) on the device and in the dtype of
        ``table``; ``table`` itself for every row."""
        if lo == 0 and n == self.domain.shape[0]:
            return self.table
        return self.row_tables(lo, n, self.table.wgt)

    def rows_partial(self, x, lo=None):
        """Every ray's integral over the grid's rows ``[lo, lo + len(x))``,
        ``x`` those rows (over the whole grid for ``lo`` None)."""
        table = self.table if lo is None else self.rows_table(lo, x.shape[0])
        return table @ x.reshape(-1)

    def forward(self, x):
        return _field_aware(self, x)
