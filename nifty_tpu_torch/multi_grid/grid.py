"""Charted refinement grids for multi-grid Gaussian processes
(counterpart of ``nifty_tpu/multi_grid/grid.py``, a copy: host numpy
geometry evaluated when a model is built).

A `Grid` describes a hierarchy of progressively finer pixelizations of a
chart.  Levels follow the *open-grid* scheme: each refinement step keeps
only the interior of the coarse level (shrinking by the stencil padding)
and splits every surviving cell, so every refinement stencil is complete
and, on uniform charts, the refinement is translation-invariant: one
stencil matrix pair per level (see ``kernel.py``).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

__all__ = [
    "Grid",
    "GridLevel",
    "SimpleOpenGrid",
    "LogGrid",
    "BrokenLogGrid",
    "MGrid",
]


def _tuplify(x, ndim):
    if np.isscalar(x):
        return (int(x),) * ndim
    x = tuple(int(v) for v in x)
    if len(x) != ndim:
        raise ValueError(f"expected {ndim} entries, got {x}")
    return x


class GridLevel:
    """One level of a grid hierarchy: a shape and an index→coordinate
    chart (vectorized over trailing axes of the index array)."""

    def __init__(self, shape: Tuple[int, ...], coord_fns):
        self.shape = tuple(int(s) for s in shape)
        self._coord_fns = tuple(coord_fns)  # one callable per axis

    @property
    def ndim(self):
        return len(self.shape)

    @property
    def size(self):
        return int(np.prod(self.shape))

    def index2coord(self, index):
        """(ndim, ...) integer indices → (ncoord, ...) coordinates."""
        index = np.asarray(index)
        coords = [fn(index[d]) for d, fn in enumerate(self._coord_fns)]
        return np.stack(coords, axis=0)


class Grid:
    """Base class: a refinable chart with `depth` refinement steps.

    Subclasses provide ``at(level) -> GridLevel`` plus the static
    refinement layout used by the ICR kernel:

    - ``splits``: per-axis subdivision factor,
    - ``padding``: per-axis stencil radius consumed per refinement.
    """

    def __init__(self, shape0, splits, padding, depth):
        self.shape0 = tuple(int(s) for s in shape0)
        ndim = len(self.shape0)
        self.splits = _tuplify(splits, ndim)
        self.padding = _tuplify(padding, ndim)
        self.depth = int(depth)
        shapes = [self.shape0]
        for _ in range(self.depth):
            nxt = tuple(
                s * (n - 2 * p)
                for n, s, p in zip(shapes[-1], self.splits, self.padding)
            )
            if any(n <= 0 for n in nxt):
                raise ValueError(
                    f"grid exhausted: level shapes {shapes + [nxt]}; "
                    "reduce depth/padding or enlarge shape0"
                )
            shapes.append(nxt)
        self.shapes = tuple(shapes)

    @property
    def ndim(self):
        return len(self.shape0)

    def at(self, level: int) -> GridLevel:
        raise NotImplementedError()

    # --- refinement layout (shared by all open grids) -----------------------

    def refined_region_start(self):
        """Per-axis coarse index where the refined (interior) region
        begins — equal to the padding."""
        return self.padding

    def window_size(self):
        """Per-axis stencil extent: 2·padding + 1 coarse pixels."""
        return tuple(2 * p + 1 for p in self.padding)


class SimpleOpenGrid(Grid):
    """Uniformly spaced N-D grid with open (shrinking) refinement.

    Reference: ``nifty/re/multi_grid/grid_impl.py:225``; independent
    implementation.
    """

    def __init__(
        self,
        *,
        shape0,
        depth: int,
        distances0=1.0,
        min_coord=None,
        splits=2,
        padding=1,
    ):
        super().__init__(shape0, splits, padding, depth)
        ndim = len(self.shape0)
        if np.isscalar(distances0):
            distances0 = (float(distances0),) * ndim
        self.distances0 = tuple(float(d) for d in distances0)
        if min_coord is None:
            min_coord = (0.0,) * ndim
        # per level: (start coordinate, spacing) for each axis
        self._geom = []
        starts = [m + 0.5 * d for m, d in zip(min_coord, self.distances0)]
        dxs = list(self.distances0)
        self._geom.append((tuple(starts), tuple(dxs)))
        for _ in range(self.depth):
            new_starts, new_dxs = [], []
            for x0, dx, p, s in zip(starts, dxs, self.padding, self.splits):
                dxf = dx / s
                # first child of the first interior coarse pixel
                new_starts.append(x0 + p * dx - dx / 2.0 + dxf / 2.0)
                new_dxs.append(dxf)
            starts, dxs = new_starts, new_dxs
            self._geom.append((tuple(starts), tuple(dxs)))

    def at(self, level: int) -> GridLevel:
        starts, dxs = self._geom[level]
        fns = tuple(
            (lambda i, x0=x0, dx=dx: x0 + np.asarray(i, dtype=float) * dx)
            for x0, dx in zip(starts, dxs)
        )
        return GridLevel(self.shapes[level], fns)


class LogGrid(Grid):
    """1-D logarithmically spaced grid (e.g. a radial chart): uniform
    refinement in log-coordinate, physical coordinate = r0·exp(·).

    Reference: ``nifty/re/multi_grid/grid_impl.py:337``; independent
    implementation.
    """

    def __init__(
        self,
        *,
        shape0,
        depth: int,
        r_min: float,
        r_max: float,
        splits=2,
        padding=1,
    ):
        shape0 = (int(shape0),) if np.isscalar(shape0) else tuple(shape0)
        if len(shape0) != 1:
            raise ValueError("LogGrid is one-dimensional")
        super().__init__(shape0, splits, padding, depth)
        self.r_min, self.r_max = float(r_min), float(r_max)
        n0 = self.shape0[0]
        dlog = np.log(self.r_max / self.r_min) / n0
        starts = [np.log(self.r_min) + 0.5 * dlog]
        dls = [dlog]
        self._geom = [(starts[0], dls[0])]
        for _ in range(self.depth):
            dlf = self._geom[-1][1] / self.splits[0]
            l0 = (
                self._geom[-1][0]
                + self.padding[0] * self._geom[-1][1]
                - self._geom[-1][1] / 2.0
                + dlf / 2.0
            )
            self._geom.append((l0, dlf))

    def at(self, level: int) -> GridLevel:
        l0, dl = self._geom[level]
        fn = lambda i, l0=l0, dl=dl: np.exp(  # noqa: E731
            l0 + np.asarray(i, dtype=float) * dl
        )
        return GridLevel(self.shapes[level], (fn,))


class BrokenLogGrid(Grid):
    """1-D radial chart that is linearly spaced between ``r_min`` and
    ``r_linthresh`` and logarithmically spaced between ``r_linthresh``
    and ``r_max`` (a "symlog" radial grid: fine linear resolution near
    the origin, log resolution far out).

    The underlying refinable grid is uniform in an auxiliary coordinate
    ``g ∈ [0, 1]``; ``g`` is mapped to radius by a piecewise C¹ map
    (antilinear ``1/r`` below ``r_min`` and linear above ``r_max`` so
    that padded stencil pixels outside the nominal range stay monotone
    and finite).  Continuity and matching slopes at the two interior
    break points fix all map parameters in closed form.

    Reference behavior: ``nifty/re/multi_grid/grid_impl.py:492``
    (``BrokenLogGridAtLevel``); independent implementation.
    """

    def __init__(
        self,
        *,
        shape0,
        depth: int,
        r_min: float,
        r_linthresh: float,
        r_max: float,
        splits=2,
        padding=1,
    ):
        shape0 = (int(shape0),) if np.isscalar(shape0) else tuple(shape0)
        if len(shape0) != 1:
            raise ValueError("BrokenLogGrid is one-dimensional")
        super().__init__(shape0, splits, padding, depth)
        r_min, r_linthresh, r_max = map(float, (r_min, r_linthresh, r_max))
        if not (0.0 < r_min < r_linthresh < r_max):
            raise ValueError(
                f"need 0 < r_min < r_linthresh < r_max, got "
                f"({r_min}, {r_linthresh}, {r_max})"
            )
        self.r_min, self.r_linthresh, self.r_max = r_min, r_linthresh, r_max

        # break point g_l in [0, 1] and slopes from C¹ matching:
        #   linear:  r = r_min + a·g            on [0, g_l]
        #   log:     r = r_linthresh·e^{b(g−g_l)} on [g_l, 1]
        # continuity  a·g_l = r_linthresh − r_min, b(1−g_l) = log(r_max/r_lt)
        # smoothness  a = r_linthresh·b   ⇒  g_l = m/(1+m) with
        #   m = (1 − r_min/r_linthresh)/log(r_max/r_linthresh)
        big_l = np.log(r_max / r_linthresh)
        m = (1.0 - r_min / r_linthresh) / big_l
        self._g_l = m / (1.0 + m)
        self._b = big_l / (1.0 - self._g_l)
        self._a = r_linthresh * self._b
        # antilinear branch r = c/(g − d) below g=0: r(0)=r_min, r'(0)=a
        self._d = r_min / self._a
        self._c = -(r_min**2) / self._a
        # linear continuation above g=1 with the log branch's end slope
        self._e = self._b * r_max

        n0 = self.shape0[0]
        dg = 1.0 / n0
        self._geom = [(0.5 * dg, dg)]
        for _ in range(self.depth):
            g0, dgc = self._geom[-1]
            dgf = dgc / self.splits[0]
            self._geom.append(
                (g0 + self.padding[0] * dgc - dgc / 2.0 + dgf / 2.0, dgf)
            )

    def _g2r(self, g):
        g = np.asarray(g, dtype=float)
        lin = self.r_min + self._a * g
        log = self.r_linthresh * np.exp(self._b * (g - self._g_l))
        anti = self._c / np.where(g < 0.0, g - self._d, -self._d)
        lin_hi = self.r_max + self._e * (g - 1.0)
        r = np.where(g < self._g_l, lin, np.where(g < 1.0, log, lin_hi))
        return np.where(g < 0.0, anti, r)

    def _r2g(self, r):
        r = np.asarray(r, dtype=float)
        lin = (r - self.r_min) / self._a
        log = self._g_l + np.log(
            np.where(r > 0, r, 1.0) / self.r_linthresh
        ) / self._b
        anti = self._d + self._c / np.where(r < self.r_min, r, self.r_min)
        lin_hi = 1.0 + (r - self.r_max) / self._e
        g = np.where(
            r < self.r_linthresh, lin, np.where(r < self.r_max, log, lin_hi)
        )
        return np.where(r < self.r_min, anti, g)

    def at(self, level: int) -> GridLevel:
        g0, dg = self._geom[level]
        fn = lambda i, g0=g0, dg=dg: self._g2r(  # noqa: E731
            g0 + np.asarray(i, dtype=float) * dg
        )
        return GridLevel(self.shapes[level], (fn,))


class MGrid(Grid):
    """Cartesian product of grids refined in lockstep (e.g. a 2-D sky
    chart × a radial ``LogGrid`` for 3-D tomography).

    All factor grids must share the same depth; the product's coordinate
    is the concatenation of factor coordinates.  Reference:
    ``nifty/re/multi_grid/grid.py:491``; independent implementation.
    """

    def __init__(self, *grids: Grid):
        if not grids:
            raise ValueError("need at least one grid")
        depth = grids[0].depth
        if any(g.depth != depth for g in grids):
            raise ValueError("all factor grids must have the same depth")
        self.grids = tuple(grids)
        shape0 = sum((g.shape0 for g in grids), ())
        splits = sum((g.splits for g in grids), ())
        padding = sum((g.padding for g in grids), ())
        super().__init__(shape0, splits, padding, depth)

    def at(self, level: int) -> GridLevel:
        levels = [g.at(level) for g in self.grids]
        fns = sum((lvl._coord_fns for lvl in levels), ())
        return GridLevel(self.shapes[level], fns)
