"""Iterative charted refinement (ICR) kernels (counterpart of
``nifty_tpu/multi_grid/kernel.py``).

A multi-grid GP sample is built coarse to fine: the base level is an
explicit Cholesky draw; every refinement step predicts the children of
each interior coarse cell from its stencil neighbourhood and adds the
conditional fluctuation,

    fine_b = OLF_b · window_b + KER_b · ξ_b ,

with ``OLF = Σ_fc Σ_cc⁻¹`` and ``KER KERᵀ = Σ_ff - Σ_fc Σ_cc⁻¹ Σ_cfᵀ``
from the covariance function on the stencil geometry.

The stencils are deduplicated on the host when the kernel is built
(:class:`_LevelLayout`, per axis and within a tolerance): a uniform chart
has one stencil per level, a chart with one non-uniform (log-radial) axis
one per shell.  On the device a uniform level is one VALID convolution
with ``prod(splits)`` output channels (``torch.nn.functional.conv{1,2,3}d``,
run with cuDNN's TF32 off whatever the process has set), a per-shell
level a batched ``einsum``; windows are views of shifted slices, the
children's scatter a ``reshape`` and ``permute``.  The matrices come
from the covariance on float64 distance tables and a batched Cholesky (and
a solve) in float64, cast to the working dtype: a conditional covariance
is a small difference of covariances, and from float32 covariances it is
not positive definite (a learned Matérn field's MGVI draw turned NaN in
float32).
"""

from __future__ import annotations

import contextlib
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ..device import Float64Tables
from .grid import Grid

__all__ = ["ICRKernel", "apply_kernel", "refinement_matrices"]


class _LevelLayout:
    """The static (numpy) refinement layout of one level.

    Stencils are deduplicated **per axis**: block positions along an axis
    whose (window + children) coordinate pattern is translation-invariant
    collapse to one pattern, so nothing of size O(n_blocks) beyond two
    small index vectors is built."""

    def __init__(self, grid: Grid, level: int, rtol: float, atol: float):
        self.level = level
        cshape, fshape = grid.shapes[level], grid.shapes[level + 1]
        pad, splits, ndim = grid.padding, grid.splits, grid.ndim
        self.block_shape = tuple(c - 2 * p for c, p in zip(cshape, pad))
        self.n_blocks = int(np.prod(self.block_shape))
        self.window_shape = tuple(2 * p + 1 for p in pad)
        self.w = int(np.prod(self.window_shape))
        self.c = int(np.prod(splits))
        self.cshape, self.fshape, self.pad, self.splits = cshape, fshape, pad, splits
        glvl_c, glvl_f = grid.at(level), grid.at(level + 1)

        # per axis d and block position b: the window's and the children's
        # coordinates along d (the charts are separable)
        axis_coords, axis_inv, axis_n_unique = [], [], []
        for d in range(ndim):
            b = np.arange(self.block_shape[d])
            cw = (b[:, None] + pad[d]) + np.arange(-pad[d], pad[d] + 1)[None]
            cf = b[:, None] * splits[d] + np.arange(splits[d])[None]
            idx_c = np.zeros((ndim,) + cw.shape, dtype=int)
            idx_c[d] = cw
            idx_f = np.zeros((ndim,) + cf.shape, dtype=int)
            idx_f[d] = cf
            coords_d = np.concatenate(
                [glvl_c.index2coord(idx_c)[d], glvl_f.index2coord(idx_f)[d]], axis=1)
            axis_coords.append(coords_d)
            rel = coords_d - coords_d[:, :1]
            scale = max(np.abs(rel).max(), atol)
            key = np.round(rel / (rtol * scale + atol)).astype(np.int64)
            _, uidx, inv = np.unique(key, axis=0, return_index=True, return_inverse=True)
            axis_inv.append(None if uidx.size == 1 else inv.ravel())
            axis_n_unique.append(uidx.size)
        self.varying_axes = [d for d in range(ndim) if axis_inv[d] is not None]

        # one representative block position per unique combination
        combos = [np.arange(axis_n_unique[d]) if axis_inv[d] is not None else [0]
                  for d in range(ndim)]
        reps = []
        for d in range(ndim):
            if axis_inv[d] is None:
                reps.append(np.zeros(1, dtype=int))
            else:
                reps.append(np.array([int(np.argmax(axis_inv[d] == u))
                                      for u in range(axis_n_unique[d])]))
        mesh = np.meshgrid(*combos, indexing="ij")
        combo_ids = np.stack([m.ravel() for m in mesh], axis=0)  # (ndim, nu)
        t = self.w + self.c
        offs_nd = np.stack(np.meshgrid(*[np.arange(ws) for ws in self.window_shape],
                                       indexing="ij"), axis=0).reshape(ndim, -1)
        childs_nd = np.stack(np.meshgrid(*[np.arange(s) for s in splits], indexing="ij"),
                             axis=0).reshape(ndim, -1)
        d2 = np.zeros((combo_ids.shape[1], t, t))
        for d in range(ndim):
            coords_d = axis_coords[d][reps[d][combo_ids[d]]]  # (nu, w_d + s_d)
            ent = np.concatenate([coords_d[:, offs_nd[d]],
                                  coords_d[:, self.window_shape[d] + childs_nd[d]]], axis=1)
            d2 += (ent[:, :, None] - ent[:, None, :]) ** 2
        self.dist_unique = np.sqrt(d2)
        self.n_unique = combo_ids.shape[1]
        self.axis_inv = axis_inv
        self.axis_n_unique = axis_n_unique

    def block_ids(self):
        """The unique-stencil id of every block (the several-axes case)."""
        inv_axes = np.meshgrid(*[
            self.axis_inv[d] if self.axis_inv[d] is not None
            else np.zeros(self.block_shape[d], dtype=int)
            for d in range(len(self.block_shape))], indexing="ij")
        uid = np.zeros(self.block_shape, dtype=np.int64)
        stride = 1
        for d in reversed(range(len(self.block_shape))):
            if self.axis_inv[d] is not None:
                uid += inv_axes[d] * stride
                stride *= self.axis_n_unique[d]
        return uid.ravel()


@contextlib.contextmanager
def _full_precision_convolutions():
    """cuDNN's TF32 off inside, whatever the process has set."""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


_CONV = {1: torch.nn.functional.conv1d, 2: torch.nn.functional.conv2d,
         3: torch.nn.functional.conv3d}


def _extract_windows(x, window_shape, block_shape):
    """Coarse array -> (n_blocks, W) stencil windows, from shifted views."""
    views = [x[tuple(slice(o, o + b) for o, b in zip(off, block_shape))]
             for off in np.ndindex(*window_shape)]
    return torch.stack(views, dim=-1).reshape(-1, len(views))


def _extract_blocks(x, splits, block_shape):
    """Fine array -> (n_blocks, C) children blocks (reshape and permute)."""
    ndim = len(splits)
    x = x.reshape(sum(((b, s) for b, s in zip(block_shape, splits)), ()))
    x = x.permute(list(range(0, 2 * ndim, 2)) + list(range(1, 2 * ndim, 2)))
    return x.reshape(-1, int(np.prod(splits)))


def _insert_blocks(y, splits, block_shape):
    """Inverse of :func:`_extract_blocks`: (n_blocks, C) -> fine array."""
    ndim = len(splits)
    y = y.reshape(tuple(block_shape) + tuple(splits))
    y = y.permute(sum(([i, ndim + i] for i in range(ndim)), []))
    return y.reshape(tuple(b * s for b, s in zip(block_shape, splits)))


def refinement_matrices(cov, w: int, jitter, dtype, cc_jitter=None):
    """``(OLF, KER)`` of a stack of stencil covariances ``cov`` (..., w + c,
    w + c), the first ``w`` entries the window's: computed in float64 and
    returned in ``dtype`` (the field's: a learned covariance's scalars may
    arrive in another).  ``cc_jitter`` is added to the window block before
    the solve, ``jitter`` to the conditional covariance."""
    dt = dtype
    cov = cov.to(torch.float64)
    cc, fc, ff = cov[..., :w, :w], cov[..., w:, :w], cov[..., w:, w:]
    if cc_jitter is not None:
        cc = cc + cc_jitter * torch.eye(w, dtype=cov.dtype, device=cov.device)
    olf = torch.linalg.solve(cc, fc.transpose(-1, -2)).transpose(-1, -2)
    cond = ff - olf @ fc.transpose(-1, -2)
    c = ff.shape[-1]
    ker = torch.linalg.cholesky_ex(cond + jitter * torch.eye(c, dtype=cov.dtype, device=cov.device))[0]
    return olf.to(dt), ker.to(dt)


def base_factor(cov, jitter, dtype):
    """The base level's Cholesky factor of ``cov`` + jitter, in float64,
    returned in ``dtype``."""
    n = cov.shape[-1]
    c64 = cov.to(torch.float64) + jitter * torch.eye(n, dtype=torch.float64, device=cov.device)
    return torch.linalg.cholesky_ex(c64)[0].to(dtype)


class _FixedMatrices(torch.nn.Module):
    """Refinement matrices as buffers (a fixed covariance's), so that they
    follow the kernel to its device and dtype."""

    def __init__(self, base_l, lvl_mats):
        super().__init__()
        self.register_buffer("base_l", base_l)
        for i, (olf, ker) in enumerate(lvl_mats):
            self.register_buffer(f"olf_{i}", olf)
            self.register_buffer(f"ker_{i}", ker)
        self.depth = len(lvl_mats)

    def get(self):
        return self.base_l, [(getattr(self, f"olf_{i}"), getattr(self, f"ker_{i}"))
                             for i in range(self.depth)]


class KernelTables(Float64Tables):
    """The base of the ICR kernels: stencil distance tables that stay
    float64 whatever ``.to`` is given (a conditional covariance is a small
    difference of covariances, which float32 distances and covariances
    round away), and ``field_dtype``, a 0-d buffer ``.to`` casts, whose
    dtype the refinement matrices are returned in."""

    def __init__(self):
        super().__init__()
        self.register_buffer("field_dtype", torch.zeros((), dtype=torch.float64))


class ICRKernel(KernelTables):
    """The refinement kernel on ``grid`` for an isotropic covariance
    ``cov(r)`` of (tensors of) Euclidean chart distances: given here for a
    fixed kernel (its matrices computed once, in float64), or passed to
    :meth:`matrices` by a model with a learned one.  Built on the CPU in
    float64; ``.to`` moves and casts it."""

    def __init__(self, grid: Grid, covariance: Optional[Callable] = None, *, rtol: float = 1e-5,
                 atol: float = 1e-10, jitter: float = 1e-10):
        super().__init__()
        self.grid = grid
        self.jitter = float(jitter)
        self._layouts = [_LevelLayout(grid, lvl, rtol, atol) for lvl in range(grid.depth)]
        g0 = grid.at(0)
        idx0 = np.stack(np.meshgrid(*[np.arange(n) for n in g0.shape], indexing="ij"),
                        axis=0).reshape(grid.ndim, -1)
        c0 = g0.index2coord(idx0)
        d = c0[:, :, None] - c0[:, None, :]
        self.register_f64("base_dist", np.sqrt((d**2).sum(axis=0)))
        for i, lay in enumerate(self._layouts):
            self.register_f64(f"dist_{i}", lay.dist_unique)
            if len(lay.varying_axes) == 1:
                inv = lay.axis_inv[lay.varying_axes[0]]
                self.register_buffer(f"shell_{i}", torch.from_numpy(inv.astype(np.int64)))
            elif lay.n_unique > 1:
                self.register_buffer(f"block_id_{i}", torch.from_numpy(lay.block_ids()))
        self.covariance = covariance
        self.fixed = _FixedMatrices(*self.matrices(covariance)) if covariance is not None else None

    @property
    def depth(self):
        return self.grid.depth

    def domain_shapes(self):
        """The excitation shapes per level."""
        return list(self.grid.shapes)

    def matrices(self, cov_fn: Callable):
        """The refinement matrices for ``cov_fn(r)``: the base level's
        Cholesky factor and each level's (OLF, KER) over the unique
        stencils."""
        dt = self.field_dtype.dtype
        base_l = base_factor(cov_fn(self.base_dist), self.jitter, dt)
        lvl_mats = [refinement_matrices(cov_fn(getattr(self, f"dist_{i}")), lay.w, self.jitter, dt)
                    for i, lay in enumerate(self._layouts)]
        return base_l, lvl_mats

    def apply(self, xs: Sequence, matrices=None):
        """Refine the per-level excitations ``xs`` (depth + 1 of them) into
        the finest level's field."""
        if matrices is None:
            if self.fixed is None:
                raise ValueError("no covariance set; pass `matrices`")
            matrices = self.fixed.get()
        base_l, lvl_mats = matrices
        if len(xs) != self.depth + 1:
            raise ValueError(f"need {self.depth + 1} excitation levels, got {len(xs)}")
        x = (base_l @ xs[0].reshape(-1)).reshape(self.grid.shapes[0])
        for i, (lay, (olf, ker)) in enumerate(zip(self._layouts, lvl_mats)):
            xi = _extract_blocks(xs[lay.level + 1], lay.splits, lay.block_shape)
            ndim = len(lay.block_shape)
            if lay.n_unique == 1 and 1 <= ndim <= 3:
                # a translation-invariant stencil: one VALID convolution with
                # prod(splits) output channels reads the coarse field once
                w = olf[0].reshape((lay.c, 1) + lay.window_shape).to(x.dtype)
                with _full_precision_convolutions():
                    y = _CONV[ndim](x[None, None], w)[0]  # (C, *blocks)
                y = y.movedim(0, -1).reshape(lay.n_blocks, lay.c) + xi @ ker[0].T
            elif lay.n_unique == 1:
                win = _extract_windows(x, lay.window_shape, lay.block_shape)
                y = win @ olf[0].T + xi @ ker[0].T
            elif len(lay.varying_axes) == 1:
                # one non-uniform axis (a log-radial one): per-shell matrices
                win = _extract_windows(x, lay.window_shape, lay.block_shape)
                k = lay.varying_axes[0]
                shell = getattr(self, f"shell_{i}")
                b_k = lay.block_shape[k]

                def regroup(a, width):
                    a = a.reshape(lay.block_shape + (width,)).movedim(k, 0)
                    return a.reshape(b_k, -1, width)

                y = (torch.einsum("krw,kcw->krc", regroup(win, lay.w), olf[shell])
                     + torch.einsum("krw,kcw->krc", regroup(xi, lay.c), ker[shell]))
                rest = tuple(b for d, b in enumerate(lay.block_shape) if d != k)
                y = y.reshape((b_k,) + rest + (lay.c,)).movedim(0, k).reshape(lay.n_blocks, lay.c)
            else:
                # several non-uniform axes: per-block matrices
                win = _extract_windows(x, lay.window_shape, lay.block_shape)
                uid = getattr(self, f"block_id_{i}")
                y = (torch.einsum("bcw,bw->bc", olf[uid], win)
                     + torch.einsum("bcw,bw->bc", ker[uid], xi))
            x = _insert_blocks(y, lay.splits, lay.block_shape)
        return x


def apply_kernel(xs, *, kernel: ICRKernel, matrices=None):
    """Functional alias for :meth:`ICRKernel.apply`."""
    return kernel.apply(xs, matrices=matrices)
