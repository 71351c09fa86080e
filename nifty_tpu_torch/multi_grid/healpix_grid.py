"""Multi-grid GP charts on the HEALPix sphere (counterpart of
``nifty_tpu/multi_grid/healpix_grid.py``).

NEST-ordered HEALPix nests: the children of pixel ``p`` at nside ``n`` are
``4p..4p+3`` at ``2n``, so the children's scatter is a reshape, and the
9-pixel stencil (the parent and its 8 neighbours) drives the conditional
refinement as the regular-grid ICR kernel does.  The stencils come from
the port's own HEALPix functions (:mod:`..ops.jhealpix`, int64), built
on the host when the kernel is.

Stencil distance matrices are congruent for pixels in symmetric places,
so a tolerant deduplication, in chunks, leaves O(nside) unique matrices.
Distances are chordal distances on the unit sphere.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ..ops import jhealpix
from .correlated_field import _ICRModel
from .kernel import KernelTables, _FixedMatrices, base_factor, refinement_matrices

__all__ = ["HEALPixICRField", "HEALPixICRKernel", "HEALPixRefinementGrid"]


def _nest_vectors(nside: int, pix) -> np.ndarray:
    """Unit vectors of NEST pixels, shape (npix, 3)."""
    z, phi = jhealpix.pix2ang_ring(nside, jhealpix.nest2ring(nside, pix))
    z, phi = z.numpy(), phi.numpy()
    s = np.sqrt(1.0 - z**2)
    return np.stack([s * np.cos(phi), s * np.sin(phi), z], axis=-1)


def _stencils(nside: int):
    """Each NEST pixel and its 8 neighbours, a missing corner neighbour
    replaced by the pixel itself: (npix, 9)."""
    pix = np.arange(12 * nside * nside)
    nbrs = jhealpix.neighbors(nside, pix, nest=True).numpy()
    stencil = np.concatenate([pix[:, None], nbrs], axis=1)
    return np.where(stencil < 0, pix[:, None], stencil)


def _children_vectors(nside: int, npix: int):
    """The unit vectors of the 4 children of every pixel at nside: (npix, 4, 3)."""
    child = (4 * np.arange(npix)[:, None] + np.arange(4)[None, :]).reshape(-1)
    return _nest_vectors(2 * nside, child).reshape(npix, 4, 3)


class HEALPixRefinementGrid:
    """The nside-doubling HEALPix hierarchy (NEST ordering)."""

    def __init__(self, *, nside0: int = 1, depth: int):
        self.nside0 = int(nside0)
        self.depth = int(depth)
        self.nsides = [self.nside0 * (1 << lvl) for lvl in range(self.depth + 1)]
        self.shapes = [(12 * n * n,) for n in self.nsides]


class HEALPixICRKernel(KernelTables):
    """The ICR kernel on a :class:`HEALPixRefinementGrid` for ``cov(r)`` of
    chordal distance; matrices per unique stencil (float64 Cholesky).
    Built on the CPU in float64; ``.to`` moves and casts it."""

    def __init__(self, grid: HEALPixRefinementGrid, covariance: Optional[Callable] = None, *,
                 rtol: float = 1e-5, jitter: float = 1e-8, chunk: int = 1 << 16):
        super().__init__()
        self.grid = grid
        self.jitter = float(jitter)
        self._npix = []
        for lvl in range(grid.depth):
            nside = grid.nsides[lvl]
            npix = 12 * nside * nside
            stencil = _stencils(nside)
            vec_c = _nest_vectors(nside, np.arange(npix))
            vec_f = _children_vectors(nside, npix)
            # tolerant deduplication of the 13 x 13 distance matrices, in chunks
            sample = self._dist_chunk(vec_c, vec_f, stencil, np.arange(min(npix, 4096)))
            q = rtol * max(np.abs(sample).max(), 1e-12)
            seen, uniques = {}, []
            inv = np.empty(npix, dtype=np.int64)
            for s0 in range(0, npix, chunk):
                ids = np.arange(s0, min(s0 + chunk, npix))
                d = self._dist_chunk(vec_c, vec_f, stencil, ids)
                keys = np.round(d / q).astype(np.int64).reshape(ids.size, -1)
                for i, k in enumerate(keys):
                    u = seen.setdefault(k.tobytes(), len(uniques))
                    if u == len(uniques):
                        uniques.append(d[i])
                    inv[ids[i]] = u
            self.register_buffer(f"stencil_{lvl}", torch.from_numpy(stencil))
            self.register_buffer(f"inv_{lvl}", torch.from_numpy(inv))
            self.register_f64(f"dist_{lvl}", np.stack(uniques))
            self._npix.append(npix)
        v0 = _nest_vectors(grid.nsides[0], np.arange(12 * grid.nsides[0] ** 2))
        d = v0[:, None, :] - v0[None, :, :]
        self.register_f64("base_dist", np.sqrt((d**2).sum(-1)))
        self.covariance = covariance
        self.fixed = _FixedMatrices(*self.matrices(covariance)) if covariance is not None else None

    @staticmethod
    def _dist_chunk(vec_c, vec_f, stencil, ids):
        pts = np.concatenate([vec_c[stencil[ids]], vec_f[ids]], axis=1)  # (chunk, 13, 3)
        d = pts[:, :, None, :] - pts[:, None, :, :]
        return np.sqrt((d**2).sum(-1))

    def matrices(self, cov_fn: Callable):
        dt = self.field_dtype.dtype
        base_l = base_factor(cov_fn(self.base_dist), self.jitter, dt)
        lvl_mats = [refinement_matrices(cov_fn(getattr(self, f"dist_{lvl}")), 9, self.jitter, dt,
                                        cc_jitter=self.jitter)
                    for lvl in range(self.grid.depth)]
        return base_l, lvl_mats

    def apply(self, xs: Sequence, matrices=None):
        """Per-level NEST excitations -> the finest level's NEST field."""
        if matrices is None:
            if self.fixed is None:
                raise ValueError("no covariance set; pass `matrices`")
            matrices = self.fixed.get()
        base_l, lvl_mats = matrices
        if len(xs) != self.grid.depth + 1:
            raise ValueError(f"need {self.grid.depth + 1} excitation levels, got {len(xs)}")
        x = base_l @ xs[0].reshape(-1)
        for lvl, (olf, ker) in enumerate(lvl_mats):
            win = x[getattr(self, f"stencil_{lvl}")]  # (npix, 9)
            xi = xs[lvl + 1].reshape(self._npix[lvl], 4)
            inv = getattr(self, f"inv_{lvl}")
            y = torch.einsum("pcw,pw->pc", olf[inv], win) + torch.einsum("pcw,pw->pc", ker[inv], xi)
            x = y.reshape(-1)  # the NEST children are contiguous
        return x


class HEALPixICRField(_ICRModel):
    """A correlated field on the sphere by HEALPix charted refinement (the
    API of :class:`~.correlated_field.ICRField`: a fixed covariance
    callable of chordal distance or a model returning one).  Built on
    ``device`` (the CUDA card by default) in ``dtype``."""

    def __init__(self, grid: HEALPixRefinementGrid, kernel, *, offset: float = 0.0,
                 prefix: str = "hpicr", device=None, dtype=torch.float32):
        super().__init__(grid, kernel, lambda cov: HEALPixICRKernel(grid, cov), offset=offset,
                         prefix=prefix, device=device, dtype=dtype)
