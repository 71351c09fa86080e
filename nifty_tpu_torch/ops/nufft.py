"""Non-uniform FFTs (counterpart of ``nifty_tpu/ops/nufft.py``).

A Kaiser-Bessel interpolation NUFFT: the type 2 (uniform to non-uniform)
deapodizes the image, embeds it centred in an oversampled grid, takes
its FFT and gathers a window of ``kernel_width`` bins an axis around each
target frequency (every one of the ``kernel_width^ndim`` taps one gather
over all points); the type 1 / adjoint is its exact conjugate transpose,
written out: a scatter-add of the windowed samples onto the oversampled
grid, the unnormalised inverse FFT, the crop and the deapodization.  The
window weights are computed from the coordinates on every call, so the
type 2 is differentiable in them (:class:`VariablePositionNufft`,
:class:`ShiftedPositionFFT`).

On a row-sharded field (inside a field context, the input the rank's rows
the field noted) :func:`nufft2` is the sharded type 2 of
:mod:`~..parallel.nufft`: an exchange of column blocks before the
oversampled axis 0 is padded, the taps cut to the rank's block, and the
rank's share of the points (``np.array_split``'s block).  Coordinates that
carry a gradient (:class:`VariablePositionNufft`'s, a replicated model
input) have their cotangent summed over the ranks;
:class:`ShiftedPositionFFT` takes the rank's rows of its shifts (split
with the field's), gathers them for the coordinates, and returns the
rank's rows of its output.

Conventions: ``coords`` holds frequencies in cycles per pixel, shape
``(ndim, M)``; the type 2 computes ``y_k = Σ_j x_j · exp(-2πi · coords_k
· (j - N/2))`` (centred image indices).
"""

from __future__ import annotations

import itertools
import math
from functools import partial
from typing import Tuple

import numpy as np
import torch

from ..device import Const
from ..model import Model
from ..utils.tree import ShapeWithDtype, random_like

__all__ = ["nufft2", "nufft1", "nufft_adjoint", "VariablePositionNufft", "ShiftedPositionFFT"]


def _kb_beta(m: int, sigma: float) -> float:
    # Beatty et al. 2005 optimal Kaiser-Bessel shape
    return float(np.pi * np.sqrt((m / sigma) ** 2 * (sigma - 0.5) ** 2 - 0.8))


def _kb_kernel(u, m: int, beta: float):
    """Kaiser-Bessel window on |u| <= m/2 (u in oversampled-bin units).

    The sqrt argument is masked twice (a ``where`` before and after) so the
    gradient in ``u`` stays finite at the window edge t -> 0 (positions
    exactly on FFT bins reach it, ``ShiftedPositionFFT`` at zero shift)."""
    t = 1.0 - (2.0 * u / m) ** 2
    inside = t > 0.0
    t_safe = torch.where(inside, t, torch.ones_like(t))
    val = torch.special.i0(beta * torch.sqrt(t_safe))
    return torch.where(inside, val, torch.zeros_like(val)) / float(np.i0(beta))


def _kb_apodization(xi, m: int, beta: float):
    """Continuous Fourier transform of the KB window at image coordinate
    ``xi = j'/N_os`` (numpy, float64)."""
    arg = beta**2 - (np.pi * m * xi) ** 2
    s = np.sqrt(np.abs(arg))
    pos = np.sinh(np.maximum(s, 1e-30)) / np.maximum(s, 1e-30)
    neg = np.sinc(s / np.pi)  # sin(s)/s
    return np.where(arg >= 0.0, pos, neg) * m / float(np.i0(beta))


def _params(shape, oversampling, kernel_width):
    n_os = tuple(int(np.ceil(oversampling * n / 2) * 2) for n in shape)
    return n_os, _kb_beta(kernel_width, oversampling)


def _deapodize(x, n_os, m, beta):
    """``x`` divided by the window's apodization along each axis (the
    corrections in float64 numpy, cast to ``x``'s real dtype)."""
    real = x.real.dtype if x.is_complex() else x.dtype
    for ax, (n, no) in enumerate(zip(x.shape, n_os)):
        corr = _kb_apodization((np.arange(n) - n // 2) / no, m, beta)
        shape = [1] * x.ndim
        shape[ax] = n
        x = x / torch.as_tensor(corr.reshape(shape), device=x.device, dtype=real)
    return x


def _taps(coords, n_os, m, beta):
    """For each of the ``m^ndim`` window taps, the flat oversampled-grid
    index of every point and its weight."""
    ndim = len(n_os)
    nu = coords * torch.as_tensor(n_os, dtype=coords.dtype, device=coords.device)[:, None]
    k0 = torch.floor(nu).long()
    offs = range(-(m // 2) + 1, m // 2 + 1)
    strides = [int(np.prod(n_os[d + 1 :])) for d in range(ndim)]
    for off in itertools.product(offs, repeat=ndim):
        flat, w = 0, 1.0
        for d in range(ndim):
            kd = k0[d] + off[d]
            w = w * _kb_kernel(nu[d] - kd, m, beta)
            flat = flat + torch.remainder(kd, n_os[d]) * strides[d]
        yield flat, w


def _centre_shifts(shape):
    return [-(n // 2) for n in shape]


def nufft2(x, coords, *, oversampling: float = 2.0, kernel_width: int = 6):
    """Type-2 NUFFT (uniform to non-uniform): the DFT of the real or complex
    image ``x`` at the frequencies ``coords`` ``(ndim, M)`` in cycles per
    pixel.  Linear in ``x``, differentiable in both arguments.

    Inside a field context, on the rank's rows of a row-sharded field (a
    shape the field noted), it is the sharded NUFFT of
    :mod:`~..parallel.nufft`: the rank's share of the points.  Coordinates
    that carry a gradient have their taps cut anew at each call here; the
    models below keep them for the coordinates' values."""
    from ..parallel import collectives

    ctx = collectives.row_shard(x)
    if ctx is not None:
        from ..parallel.nufft import sharded_nufft2

        return sharded_nufft2(x, coords, ctx, oversampling=oversampling, kernel_width=kernel_width)
    shape = tuple(x.shape)
    ndim = len(shape)
    if coords.shape[0] != ndim:
        raise ValueError("coords must be (ndim, M)")
    m = int(kernel_width)
    n_os, beta = _params(shape, oversampling, m)
    x = _deapodize(x, n_os, m, beta)
    # centre the image in the padded FFT frame: index j' = j - n/2 at
    # padded position j' mod n_os
    pad = []
    for n, no in zip(reversed(shape), reversed(n_os)):
        pad += [0, no - n]
    if x.is_complex():
        padded = torch.complex(torch.nn.functional.pad(x.real, pad),
                               torch.nn.functional.pad(x.imag, pad))
    else:
        padded = torch.nn.functional.pad(x, pad)
    padded = torch.roll(padded, shifts=_centre_shifts(shape), dims=tuple(range(ndim)))
    f = torch.fft.fftn(padded).reshape(-1)
    out = None
    for flat, w in _taps(coords, n_os, m, beta):
        term = w * f[flat]
        out = term if out is None else out + term
    return out


def nufft_adjoint(y, coords, shape: Tuple[int, ...], *, oversampling: float = 2.0,
                  kernel_width: int = 6):
    """Type-1 NUFFT (non-uniform to uniform), the exact adjoint of
    :func:`nufft2` for the same parameters: the samples ``y`` gridded back
    onto a complex image of ``shape`` (complex128 for complex128 ``y``,
    else complex64)."""
    shape = tuple(int(s) for s in shape)
    ndim = len(shape)
    m = int(kernel_width)
    n_os, beta = _params(shape, oversampling, m)
    cdt = torch.complex128 if y.dtype == torch.complex128 else torch.complex64
    y = y.to(cdt)
    grid = torch.zeros(int(np.prod(n_os)), dtype=cdt, device=y.device)
    for flat, w in _taps(coords, n_os, m, beta):
        grid = grid.index_add(0, flat, w * y)
    img = torch.fft.ifftn(grid.reshape(n_os), norm="forward")  # the FFT's conjugate transpose
    img = torch.roll(img, shifts=[-s for s in _centre_shifts(shape)], dims=tuple(range(ndim)))
    img = img[tuple(slice(0, n) for n in shape)]
    return _deapodize(img, n_os, m, beta)


nufft1 = nufft_adjoint


def _sorted_domain(domain):
    """JAX orders dict keys by sort; the port keeps that order."""
    return {k: domain[k] for k in sorted(domain)}


class VariablePositionNufft(Model):
    """Type-2 NUFFT with the sampling positions as inputs: the field's
    Fourier transform at arbitrary, possibly learned, positions,
    differentiable in the grid values and the coordinates.

    Domain: ``{prefix+"coord": (ndim, npoints), prefix+"grid": grid_shape}``
    (coordinates in cycles per pixel); returns the complex visibilities
    ``(npoints,)``."""

    def __init__(self, grid_shape, npoints: int, *, oversampling: float = 2.0,
                 kernel_width: int = 6, prefix: str = "nufft"):
        self.grid_shape = tuple(int(s) for s in grid_shape)
        self.npoints = int(npoints)
        self.oversampling = float(oversampling)
        self.kernel_width = int(kernel_width)
        self._k_grid = prefix + "grid"
        self._k_coord = prefix + "coord"
        domain = _sorted_domain({
            self._k_grid: ShapeWithDtype(self.grid_shape),
            self._k_coord: ShapeWithDtype((len(self.grid_shape), self.npoints)),
        })
        init = {k: partial(random_like, primals=v) for k, v in domain.items()}
        self._plans = {}  # on a row-sharded field: the taps of the coordinates' values
        super().__init__(domain=domain, init=init)

    def forward(self, x):
        from ..parallel import collectives

        grid, coords = x[self._k_grid], x[self._k_coord]
        ctx = collectives.row_shard(grid)
        if ctx is None:
            return nufft2(grid, coords, oversampling=self.oversampling, kernel_width=self.kernel_width)
        from ..parallel.nufft import sharded_nufft2

        return sharded_nufft2(grid, coords, ctx, oversampling=self.oversampling,
                              kernel_width=self.kernel_width, plans=self._plans)


class ShiftedPositionFFT(Model):
    """FFT on a regular grid whose sampling positions may be perturbed: the
    NUFFT at the standard FFT frequencies plus learned per-mode shifts
    ``delta`` in units of the frequency spacing (0 gives the plain FFT).

    Domain: ``{prefix+"delta_coord": (n_shift_dirs,) + grid_shape,
    prefix+"grid": grid_shape}``; the output has the grid's shape
    (complex)."""

    def __init__(self, grid_shape, *, shift_directions=None, oversampling: float = 2.0,
                 kernel_width: int = 6, prefix: str = "spfft"):
        self.grid_shape = tuple(int(s) for s in grid_shape)
        ndim = len(self.grid_shape)
        if shift_directions is None:
            shift_directions = tuple(range(ndim))
        elif isinstance(shift_directions, int):
            shift_directions = (shift_directions,)
        self.shift_directions = tuple(sorted(set(int(d) for d in shift_directions)))
        if any(d < 0 or d >= ndim for d in self.shift_directions):
            raise ValueError("shift_directions out of range")
        self.oversampling = float(oversampling)
        self.kernel_width = int(kernel_width)
        self._k_grid = prefix + "grid"
        self._k_delta = prefix + "delta_coord"
        domain = _sorted_domain({
            self._k_grid: ShapeWithDtype(self.grid_shape),
            self._k_delta: ShapeWithDtype((len(self.shift_directions),) + self.grid_shape),
        })
        init = {k: partial(random_like, primals=v) for k, v in domain.items()}
        # base FFT frequencies in cycles/pixel, flattened (ndim, N)
        freqs = np.meshgrid(*[np.fft.fftfreq(n) for n in self.grid_shape], indexing="ij")
        self._base = Const(np.stack([f.ravel() for f in freqs]))
        self._df = np.array([1.0 / n for n in self.grid_shape])  # one FFT bin, cycles/pixel
        self._plans = {}  # on a row-sharded field: the taps of the coordinates' values
        super().__init__(domain=domain, init=init)

    def forward(self, x):
        from ..parallel import collectives

        grid, delta = x[self._k_grid], x[self._k_delta]
        ctx = collectives.row_shard(grid)
        split = ctx is not None and delta.shape[1] != self.grid_shape[0]
        if split:  # the rank's rows of the shifts: every point's for the coordinates
            delta = collectives.all_gather(delta, ctx.group, axis=1)
        delta = delta.reshape(len(self.shift_directions), -1)
        rows = list(self._base.like(delta, delta.dtype))
        for i, d in enumerate(self.shift_directions):
            rows[d] = rows[d] + self._df[d] * delta[i]
        coords = torch.stack(rows)
        # nufft2 uses centred pixel indices (j - n//2); re-phase so that
        # delta = 0 gives the standard (corner-origin) FFT exactly
        shift = sum(coords[d] * (self.grid_shape[d] // 2) for d in range(len(self.grid_shape)))
        if ctx is None:
            vis = nufft2(grid, coords, oversampling=self.oversampling, kernel_width=self.kernel_width)
            return (vis * torch.exp(shift * (-2j * math.pi))).reshape(self.grid_shape)
        from ..parallel.nufft import sharded_nufft2

        vis = sharded_nufft2(grid, coords, ctx, oversampling=self.oversampling,
                             kernel_width=self.kernel_width, local_coords=split, plans=self._plans)
        p, r = torch.distributed.get_world_size(ctx.group), torch.distributed.get_rank(ctx.group)
        lo, hi = collectives.share(shift.shape[0], p, r)
        out = (vis * torch.exp(shift[lo:hi] * (-2j * math.pi))).reshape((-1,) + self.grid_shape[1:])
        return collectives.note_split(out)  # the rank's rows of the output
