"""Structured kernel interpolation (KISS-GP) covariances (counterpart of
``nifty_tpu/ski.py``).

GPs at arbitrary sampling points by interpolation from a regular grid of
inducing points: ``C ≈ W K_grid Wᵀ`` with ``W`` the multilinear
interpolation matrix (:func:`interp_mat`, a
:class:`~.ops.gather_reduce.PaddedSparse` of ``2^ndim`` corners a point,
applied by a gather and transposed by a deterministic gather) and the
grid covariance applied spectrally (:class:`HarmonicSKI`, through the
Hartley transform, so K3/K4 on a 2-D f32 grid whose axes are multiples of
256) or as a Toeplitz product by circulant embedding
(:class:`ToeplitzSKI`).  ``evaluate`` materialises the covariance through
``torch.func.vmap`` (for tests).
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from . import device as _device
from .models.correlated_field import get_fourier_mode_distributor
from .ops.fft import hartley
from .ops.gather_reduce import PaddedSparse

__all__ = ["matmul_toeplitz", "interp_mat", "HarmonicSKI", "ToeplitzSKI"]


def matmul_toeplitz(c, x):
    """The (symmetric-by-conjugation) Toeplitz matrix with first column
    ``c`` times ``x`` (``(n,)`` or ``(n, k)``), by circulant embedding and
    FFT."""
    c = c.reshape(-1)
    n = c.shape[0]
    if x.shape[0] != n or x.ndim > 2:
        raise ValueError("invalid matrix product dimensions")
    x2 = x.reshape(n, -1)
    emb = torch.cat([c, c.conj()[1:].flip(0)])
    p = 2 * n - 1
    if emb.is_complex() or x2.is_complex():
        prod = torch.fft.ifft(torch.fft.fft(emb)[:, None] * torch.fft.fft(x2, n=p, dim=0), dim=0)
    else:
        prod = torch.fft.irfft(torch.fft.rfft(emb)[:, None] * torch.fft.rfft(x2, n=p, dim=0),
                               n=p, dim=0)
    out = prod[:n]
    return out.reshape(x.shape) if x.ndim == 1 else out


def interp_mat(grid_shape, grid_bounds, sampling_points, *, distances=None, device=None,
               dtype=None) -> PaddedSparse:
    """The multilinear interpolation matrix from a regular grid (the
    inducing points) to ``sampling_points`` of shape ``(ndim,
    n_points)``: an ``(n_points, prod(grid_shape))``
    :class:`~.ops.gather_reduce.PaddedSparse` (``@``, ``.T``,
    ``.todense()``) on ``device`` (the CUDA card by default), weights in
    ``dtype``."""
    sampling_points = np.asarray(sampling_points)
    if sampling_points.ndim != 2:
        raise ValueError("sampling_points must be (ndim, n_points)")
    ndim, n_points = sampling_points.shape
    if (distances is None) == (grid_bounds is None):
        raise ValueError("pass exactly one of grid_bounds / distances")
    if grid_bounds is not None:
        grid_bounds = np.asarray(grid_bounds, dtype=float)
        offset = grid_bounds[:, 0]
        distances = (grid_bounds[:, 1] - grid_bounds[:, 0]) / np.asarray(grid_shape)
    else:
        offset = np.zeros(ndim)
        distances = np.broadcast_to(np.asarray(distances, float), (ndim,))

    rel = (sampling_points - offset[:, None]) / distances[:, None]
    frac, base = np.modf(rel)
    base = base.astype(np.int64)
    corners = np.stack(np.meshgrid(*([np.arange(2)] * ndim), indexing="ij"), axis=0).reshape(ndim, -1)
    n_c = corners.shape[1]
    weights = np.empty((n_c, n_points))
    cols = np.empty((n_c, n_points), dtype=np.int64)
    for i in range(n_c):
        weights[i] = np.prod(np.abs(1.0 - corners[:, i : i + 1] - frac), axis=0)
        idx = np.clip(base + corners[:, i : i + 1], 0, (np.asarray(grid_shape) - 1)[:, None])
        cols[i] = np.ravel_multi_index(idx, grid_shape)
    return PaddedSparse(cols.T, weights.T, int(np.prod(grid_shape)), device=device, dtype=dtype)


def _parse_jitter(jitter, dtype):
    if jitter is True:
        return 1e-8 if np.dtype(dtype) == np.float64 else 1e-6
    if jitter is False:
        return None
    return jitter


class HarmonicSKI(torch.nn.Module):
    """KISS-GP covariance with a spectrally represented (stationary) kernel,
    ``C = W Hᵀ diag(P) H Wᵀ`` (+ jitter), the grid padded by ``padding``
    on ``device`` (the CUDA card by default) in ``dtype``.  The harmonic
    kernel maps the unique mode lengths (a tensor) to the power."""

    def __init__(self, grid_shape, grid_bounds, sampling_points,
                 harmonic_kernel: Optional[Callable] = None, padding: float = 0.5, jitter=True,
                 *, device=None, dtype=None):
        super().__init__()
        device = _device.resolve(device)
        dtype = dtype or torch.get_default_dtype()
        sampling_points = np.asarray(sampling_points)
        self.jitter = _parse_jitter(jitter, sampling_points.dtype)
        self.grid_unpadded_shape = tuple(int(s) for s in grid_shape)
        self.w = interp_mat(grid_shape, grid_bounds, sampling_points, device=device, dtype=dtype)
        gb = np.asarray(grid_bounds, dtype=float)
        dist_up = (gb[:, 1] - gb[:, 0]) / np.asarray(grid_shape)
        self.grid_unpadded_total_volume = float(np.prod(np.asarray(grid_shape) * dist_up))
        if padding:
            pshape = tuple(int(np.ceil(s * (1.0 + padding))) for s in grid_shape)
        else:
            pshape = self.grid_unpadded_shape
        self.grid_shape = pshape
        self.grid_distances = dist_up  # spacing unchanged; domain enlarged
        self.grid_total_volume = float(np.prod(np.asarray(pshape) * dist_up))
        self.subslice = tuple(slice(0, s) for s in self.grid_unpadded_shape)
        pd, um, _ = get_fourier_mode_distributor(self.grid_shape, self.grid_distances)
        self.register_buffer("power_distributor", torch.as_tensor(pd, device=device))
        self.register_buffer("unique_mode_lengths", torch.as_tensor(um, device=device, dtype=dtype))
        self._harmonic_kernel = harmonic_kernel

    @property
    def harmonic_kernel(self) -> Callable:
        if self._harmonic_kernel is None:
            raise TypeError("no harmonic kernel set")
        return self._harmonic_kernel

    def power(self, harmonic_kernel=None):
        hk = self.harmonic_kernel if harmonic_kernel is None else harmonic_kernel
        power = hk(self.unique_mode_lengths)
        return power * (self.grid_total_volume / self.grid_unpadded_total_volume)

    def amplitude(self, harmonic_kernel=None):
        return torch.sqrt(self.power(harmonic_kernel))

    def harmonic_transform(self, x):
        return hartley(x) / self.grid_total_volume

    def correlated_field(self, x, harmonic_kernel=None):
        """Sample-path model on the (unpadded) grid: coloured excitations."""
        amp = self.amplitude(harmonic_kernel)
        f = self.harmonic_transform(amp[self.power_distributor] * x)
        return f[self.subslice]

    def sandwich(self, x, harmonic_kernel=None):
        """``Hᵀ diag(P) H`` on the padded grid, cut back to the unpadded
        one; ``Hᵀ`` is ``H`` (the Hartley transform is symmetric)."""
        pad = []
        for n, p in zip(reversed(x.shape), reversed(self.grid_shape)):
            pad += [0, p - n]
        x_pad = torch.nn.functional.pad(x, pad)
        power = self.power(harmonic_kernel)
        s = self.harmonic_transform(power[self.power_distributor] * self.harmonic_transform(x_pad))
        return s[self.subslice]

    def forward(self, x, harmonic_kernel=None):
        """The SKI covariance applied to data-space ``x``."""
        g = (self.w.T @ x.reshape(-1)).reshape(self.grid_unpadded_shape)
        g = self.sandwich(g, harmonic_kernel=harmonic_kernel)
        out = (self.w @ g.reshape(-1)).reshape(x.shape)
        return out if self.jitter is None else out + self.jitter * x

    def evaluate(self, harmonic_kernel=None):
        """The full covariance (for tests)."""
        eye = torch.eye(self.w.shape[0], dtype=self.unique_mode_lengths.dtype,
                        device=self.unique_mode_lengths.device)
        return torch.func.vmap(lambda e: self(e, harmonic_kernel=harmonic_kernel))(eye).T


class ToeplitzSKI(torch.nn.Module):
    """KISS-GP covariance with the grid kernel applied as an (implicitly
    embedded) Toeplitz matrix, for kernels given in position space (a map
    of distances, a tensor, to covariances), on ``device`` (the CUDA card
    by default) in ``dtype``.  One-dimensional grids only: on a raveled
    grid of more axes the kernel matrix is block-Toeplitz, not Toeplitz
    (the JAX package applies the 1-D product to it all the same)."""

    def __init__(self, grid_shape, grid_bounds, sampling_points, kernel: Optional[Callable] = None,
                 jitter=True, *, device=None, dtype=None):
        super().__init__()
        device = _device.resolve(device)
        dtype = dtype or torch.get_default_dtype()
        sampling_points = np.asarray(sampling_points)
        self.jitter = _parse_jitter(jitter, sampling_points.dtype)
        self.grid_shape = tuple(int(s) for s in grid_shape)
        if len(self.grid_shape) != 1:
            raise ValueError(f"ToeplitzSKI takes a 1-D grid, not {self.grid_shape}")
        gb = np.asarray(grid_bounds, dtype=float)
        self.grid_distances = (gb[:, 1] - gb[:, 0]) / np.asarray(grid_shape)
        mg = np.mgrid[tuple(slice(s) for s in self.grid_shape)].astype(float)
        mg *= self.grid_distances.reshape((-1,) + (1,) * len(self.grid_shape))
        self.register_buffer("grid_distances_to_zero", torch.as_tensor(
            np.linalg.norm(mg, axis=0), device=device, dtype=dtype))
        self.w = interp_mat(grid_shape, grid_bounds, sampling_points, device=device, dtype=dtype)
        self._kernel = kernel

    @property
    def kernel(self) -> Callable:
        if self._kernel is None:
            raise TypeError("no kernel set")
        return self._kernel

    def forward(self, x, kernel=None):
        kernel = self.kernel if kernel is None else kernel
        g = self.w.T @ x.reshape(-1)
        g = matmul_toeplitz(kernel(self.grid_distances_to_zero).reshape(-1), g)
        out = (self.w @ g).reshape(x.shape)
        return out if self.jitter is None else out + self.jitter * x

    def evaluate(self, kernel=None):
        eye = torch.eye(self.w.shape[0], dtype=self.grid_distances_to_zero.dtype,
                        device=self.grid_distances_to_zero.device)
        return torch.func.vmap(lambda e: self(e, kernel=kernel))(eye).T
