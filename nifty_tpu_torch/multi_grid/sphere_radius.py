"""Sphere × log-radius multi-grid charts for all-sky tomography
(counterpart of ``nifty_tpu/multi_grid/sphere_radius.py``).

The product of a HEALPix refinement chart (NEST, nside doubling) with an
open log-radial chart, refined in lockstep.  Stencils factorise: 9
spherical neighbours × (2 pad + 1) radial shells predict 4 × s_r
children.  The unique stencil classes are the HEALPix ring-symmetry
classes times the radial block positions, so the matrices stay
O(nside n_r) while the field grows O(12 nside² n_r).  Points embed in R³
as r·v̂ with chordal distances.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch

from .correlated_field import _ICRModel
from .grid import BrokenLogGrid, LogGrid
from .healpix_grid import HEALPixRefinementGrid, _children_vectors, _nest_vectors, _stencils
from .kernel import KernelTables, _FixedMatrices, base_factor, refinement_matrices

__all__ = ["SphereLogRadiusGrid", "SphereRadiusICRField", "SphereRadiusICRKernel"]


class SphereLogRadiusGrid:
    """HEALPix sphere × open radial grid (log, or with ``r_linthresh`` linear
    inside it and log outside), refined in lockstep: nside doubles, the
    radial cells split by ``r_splits``."""

    def __init__(self, *, nside0: int = 1, n_r0: int, r_min: float, r_max: float, depth: int,
                 r_padding: int = 1, r_splits: int = 2, r_linthresh: Optional[float] = None):
        self.sphere = HEALPixRefinementGrid(nside0=nside0, depth=depth)
        if r_linthresh is None:
            self.radial = LogGrid(shape0=n_r0, depth=depth, r_min=r_min, r_max=r_max,
                                  padding=r_padding, splits=r_splits)
        else:
            self.radial = BrokenLogGrid(shape0=n_r0, depth=depth, r_min=r_min,
                                        r_linthresh=r_linthresh, r_max=r_max, padding=r_padding,
                                        splits=r_splits)
        self.depth = int(depth)
        self.shapes = [(12 * n * n, m[0]) for n, m in zip(self.sphere.nsides, self.radial.shapes)]


class SphereRadiusICRKernel(KernelTables):
    """The ICR kernel on a :class:`SphereLogRadiusGrid` for an isotropic 3-D
    covariance ``cov(r)`` of Euclidean distance, with a jitter relative to
    ``cov(0)``.  Per-block matrices are gathered per (angular class, radial
    shell), ``(npix, B_r, C, W)`` a level.  Built on the CPU in float64;
    ``.to`` moves and casts it."""

    def __init__(self, grid: SphereLogRadiusGrid, covariance: Optional[Callable] = None, *,
                 rtol: float = 1e-5, jitter: float = 1e-6):
        super().__init__()
        self.grid = grid
        self.jitter = float(jitter)
        rad = grid.radial
        self._layouts = []
        for lvl in range(grid.depth):
            nside = grid.sphere.nsides[lvl]
            npix = 12 * nside * nside
            stencil = _stencils(nside)
            vec_c = _nest_vectors(nside, np.arange(npix))
            vec_f = _children_vectors(nside, npix)
            # angular classes: deduplicate the 13 x 13 dot-product matrices
            dirs = np.concatenate([vec_c[stencil], vec_f], axis=1)  # (npix, 13, 3)
            dots = np.einsum("pik,pjk->pij", dirs, dirs)
            keys = np.round(dots / rtol).astype(np.int64).reshape(npix, -1)
            _, uidx, inv_s = np.unique(keys, axis=0, return_index=True, return_inverse=True)
            rep_dirs = dirs[uidx]
            n_us = uidx.size
            # the radial windows and children of each radial block
            p_r, s_r = rad.padding[0], rad.splits[0]
            b_r = rad.shapes[lvl][0] - 2 * p_r
            br = np.arange(b_r)
            rw_idx = (br[:, None] + p_r) + np.arange(-p_r, p_r + 1)[None]
            rf_idx = br[:, None] * s_r + np.arange(s_r)[None]
            r_w = rad.at(lvl).index2coord(rw_idx[None])[0]  # (b_r, w_r)
            r_f = rad.at(lvl + 1).index2coord(rf_idx[None])[0]  # (b_r, s_r)
            w_r = 2 * p_r + 1
            # coarse: 9 directions × w_r radii, fine: 4 directions × s_r radii
            dc = (rep_dirs[:, None, :9, None, :] * r_w[None, :, None, :, None]).reshape(
                n_us, b_r, 9 * w_r, 3)
            df = (rep_dirs[:, None, 9:, None, :] * r_f[None, :, None, :, None]).reshape(
                n_us, b_r, 4 * s_r, 3)
            pts = np.concatenate([dc, df], axis=2)
            diff = pts[:, :, :, None, :] - pts[:, :, None, :, :]
            self.register_buffer(f"stencil_{lvl}", torch.from_numpy(stencil))
            self.register_buffer(f"inv_{lvl}", torch.from_numpy(inv_s.ravel().astype(np.int64)))
            self.register_f64(f"dist_{lvl}", np.sqrt((diff**2).sum(-1)))
            self._layouts.append(dict(npix=npix, w=9 * w_r, w_r=w_r, s_r=s_r, b_r=b_r))
        n0 = grid.sphere.nsides[0]
        v0 = _nest_vectors(n0, np.arange(12 * n0 * n0))
        r0 = rad.at(0).index2coord(np.arange(rad.shapes[0][0])[None])[0]
        pts0 = (v0[:, None, :] * r0[None, :, None]).reshape(-1, 3)
        d = pts0[:, None, :] - pts0[None, :, :]
        self.register_f64("base_dist", np.sqrt((d**2).sum(-1)))
        self.covariance = covariance
        self.fixed = _FixedMatrices(*self.matrices(covariance)) if covariance is not None else None

    def matrices(self, cov_fn: Callable):
        base, dt = self.base_dist, self.field_dtype.dtype
        cov0 = cov_fn(base.new_zeros(())).to(torch.float64)  # a jitter relative to cov(0)
        base_l = base_factor(cov_fn(base), self.jitter * cov0, dt)
        lvl_mats = [refinement_matrices(cov_fn(getattr(self, f"dist_{lvl}")), lay["w"],
                                        self.jitter * cov0, dt, cc_jitter=self.jitter * cov0)
                    for lvl, lay in enumerate(self._layouts)]
        return base_l, lvl_mats

    def apply(self, xs: Sequence, matrices=None):
        if matrices is None:
            if self.fixed is None:
                raise ValueError("no covariance set; pass `matrices`")
            matrices = self.fixed.get()
        base_l, lvl_mats = matrices
        if len(xs) != self.grid.depth + 1:
            raise ValueError(f"need {self.grid.depth + 1} excitation levels, got {len(xs)}")
        x = (base_l @ xs[0].reshape(-1)).reshape(self.grid.shapes[0])
        for lvl, (lay, (olf, ker)) in enumerate(zip(self._layouts, lvl_mats)):
            npix, b_r, w_r, s_r = lay["npix"], lay["b_r"], lay["w_r"], lay["s_r"]
            # windows: the spherical gather × the radial slices
            xs_g = x[getattr(self, f"stencil_{lvl}")]  # (npix, 9, n_rc)
            win = torch.stack([xs_g[:, :, o: o + b_r] for o in range(w_r)], dim=-1)
            win = win.permute(0, 2, 1, 3).reshape(npix, b_r, 9 * w_r)
            xi = xs[lvl + 1].reshape(npix, 4, b_r, s_r).permute(0, 2, 1, 3).reshape(
                npix, b_r, 4 * s_r)
            inv = getattr(self, f"inv_{lvl}")
            y = (torch.einsum("pbcw,pbw->pbc", olf[inv], win)
                 + torch.einsum("pbcw,pbw->pbc", ker[inv], xi))
            x = y.reshape(npix, b_r, 4, s_r).permute(0, 2, 1, 3).reshape(4 * npix, b_r * s_r)
        return x


class SphereRadiusICRField(_ICRModel):
    """A correlated field on sphere × log-radius (a 3-D tomography prior).
    Built on ``device`` (the CUDA card by default) in ``dtype``."""

    def __init__(self, grid: SphereLogRadiusGrid, kernel, *, offset=0.0, prefix: str = "srf",
                 device=None, dtype=torch.float32):
        super().__init__(grid, kernel, lambda cov: SphereRadiusICRKernel(grid, cov), offset=offset,
                         prefix=prefix, device=device, dtype=dtype)
