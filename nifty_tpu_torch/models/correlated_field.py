"""Correlated-field GP prior (counterpart of
``nifty_tpu/models/correlated_field.py``).

A standard-normal excitation ξ in harmonic space is coloured by an
amplitude spectrum (a power law in log|k| plus integrated-Wiener-process
deviations), scaled by a global zero mode and mapped to position space by
the Hartley transform.  Two forms of the spectrum:

- exact (the default): one value per unique |k|.  The mode binning is
  computed with numpy when the model is built; at run time only the
  expansion of the amplitude table onto the full grid (K1, its adjoint K2)
  and the Hartley (K3 + K4) touch the grid;
- knots (``n_mode_knots=K``): the deviations live on K log-equidistant
  knots and the amplitude is evaluated per pixel of the non-redundant |k|
  core (``n//2+1`` per axis) through the relu-feature map
  (:mod:`..ops.pwl`), then mirror-unfolded onto the full grid.  No table,
  no gather: only the Hartley touches the full grid.

A Matérn amplitude (:meth:`CorrelatedFieldMaker.add_fluctuations_matern`)
has the same two forms: its closed-form spectrum on the unique-|k| table
(expanded by K1, as the exact form), or with ``pixel_expansion=True`` per
pixel of the |k| core, mirror-unfolded (no table, no gather).  Every
amplitude answers :attr:`per_pixel`, which picks the field's branch.  The
renormalisations sum in float64: at 4096² a sum runs over 1.6-6.6 M core
pixels.  :func:`density_estimator` is the exponentiated Matérn field on a
padded grid.

On the HEALPix sphere (``harmonic_type="spherical"``, the shape the
single nside) the exact spectrum has one value per l; K1 expands it onto
the packed real-alm vector (a flat 1-D layout; K2 is its adjoint) and the
spherical-harmonic synthesis (:mod:`..ops.sht`, K5 and its adjoint K6)
maps it to the RING-ordered map, with the harmonic volume 1/(4π).  A
sphere and a regular grid combine as an outer product: the Hartley over
the regular axes, the synthesis over the sphere's axis.

With ``finalize(field_mesh=...)`` the field is row-sharded over the mesh
axis ``field_axis``: each rank holds the rows ``[r n0/p, (r + 1) n0/p)``
of ξ and of the output, builds only those rows of the harmonic amplitude
(the exact form through K1r, whose adjoint K2r folds only its rows; the
knot and pixel forms unfold only those rows of the core) and maps them
through the pencil Hartley (:mod:`..parallel.fft`: K3 on the rows, K4r on
a column block).  The other leaves are replicated: they enter through
:func:`~..parallel.collectives.replicate`, so their cotangents are summed
over the field axis.  :meth:`CorrelatedField.position_sharding` gives the
placements.
"""

from __future__ import annotations

import copy
from collections import namedtuple
from functools import partial
from typing import Callable, Optional

import numpy as np
import torch

from .. import device as _device
from .. import tracing
from ..model import ChainModel, Model, WrappedCall
from ..num.stats_distributions import lognormal_prior, normal_prior
from ..ops.cuda_expand import mirror_unfold
from ..ops.cuda_legendre import alm_size, real_alm_index_maps
from ..ops.fft import hartley
from ..ops.mode_expand import (
    ExpandIndex,
    build_expand_layout,
    mode_expand_grid,
    mode_expand_grid_rows,
)
from ..ops.pwl import PwlFeatures
from ..ops.sht import HealpixSynthesis
from ..utils.tree import ShapeWithDtype
from .gauss_markov import IntegratedWienerProcess

__all__ = [
    "CorrelatedField",
    "CorrelatedFieldMaker",
    "HEALPixGrid",
    "LMGrid",
    "MaternAmplitude",
    "NonParametricAmplitude",
    "RegularCartesianGrid",
    "RegularFourierGrid",
    "density_estimator",
    "get_fourier_mode_distributor",
    "get_spherical_mode_distributor",
    "make_grid",
]


# --- mode distributors -------------------------------------------------------


def _unique_mode_distributor(m_length, uniqueness_rtol=1e-12):
    """Bin harmonic modes by (tolerantly) unique |k|: the per-mode bin
    index, the unique lengths and each bin's multiplicity."""
    um = np.unique(m_length)
    tol = uniqueness_rtol * um[-1]
    um = um[np.diff(np.append(um, 2 * um[-1])) > tol]
    binbounds = 0.5 * (um[:-1] + um[1:])
    m_length_idx = np.searchsorted(binbounds, m_length)
    m_count = np.bincount(m_length_idx.ravel(), minlength=um.size)
    if np.any(m_count == 0) or um.shape != m_count.shape:
        raise RuntimeError("invalid harmonic mode(s) encountered")
    return m_length_idx, um, m_count


def get_fourier_mode_distributor(shape, distances, uniqueness_rtol=1e-12):
    """|k|-binning for the Fourier modes of a regular grid."""
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    distances = np.broadcast_to(np.atleast_1d(distances), (len(shape),))
    dk = 1.0 / (np.array(shape) * distances)
    k2 = None
    for n, d in zip(shape, dk):
        ax = np.arange(n)
        ax = (np.minimum(ax, n - ax) * d).astype(np.float64) ** 2
        k2 = ax if k2 is None else k2[..., np.newaxis] + ax
    return _unique_mode_distributor(np.sqrt(k2), uniqueness_rtol=uniqueness_rtol)


def get_spherical_mode_distributor(nside, lmax=None, mmax=None, uniqueness_rtol=1e-12):
    """l-binning of the spherical-harmonic modes in the packed real-alm
    layout: the distributor of :func:`get_fourier_mode_distributor` and
    ``(lmax, mmax, size)``."""
    lmax = 2 * nside if lmax is None else int(lmax)
    if lmax < 0:
        raise ValueError("lmax must be >= 0")
    mmax = lmax if mmax is None else int(mmax)
    if mmax < 0 or mmax > lmax:
        raise ValueError("mmax must be in [0, lmax]")
    size = alm_size(lmax, mmax)
    idx_re, msk_re, idx_im, msk_im = real_alm_index_maps(lmax, mmax)
    ell = np.broadcast_to(np.arange(lmax + 1, dtype=np.float64)[:, None], idx_re.shape)
    ldist = np.empty(size)
    for idx, msk in ((idx_re, msk_re), (idx_im, msk_im)):
        ldist[idx[msk > 0]] = ell[msk > 0]
    return (_unique_mode_distributor(ldist, uniqueness_rtol=uniqueness_rtol), (lmax, mmax, size))


# --- grids -------------------------------------------------------------------

RegularCartesianGrid = namedtuple(
    "RegularCartesianGrid",
    ("shape", "total_volume", "distances", "harmonic_grid"),
)

HEALPixGrid = namedtuple("HEALPixGrid", ("nside", "shape", "total_volume", "harmonic_grid"))

LMGrid = namedtuple(
    "LMGrid",
    (
        "lmax",
        "mmax",
        "shape",
        "power_distributor",
        "mode_multiplicity",
        "mode_lengths",
        "relative_log_mode_lengths",
        "log_volume",
    ),
)

RegularFourierGrid = namedtuple(
    "RegularFourierGrid",
    (
        "shape",
        "power_distributor",
        "mode_multiplicity",
        "mode_lengths",
        "relative_log_mode_lengths",
        "log_volume",
    ),
)


def _log_modes(m_length):
    """Relative log mode lengths and the log-k bin widths for the IWP."""
    um = m_length.copy()
    um[1:] = np.log(um[1:])
    um[1:] -= um[1]
    log_vol = um[2:] - um[1:-1]
    return um, log_vol


def _core_shape(shape):
    return tuple(n // 2 + 1 for n in shape)


# --- per-pixel |k| on the core (the knot form) --------------------------------


def _k2_grid(shape, distances, core: bool = False, device=None):
    """|k|² per harmonic-grid pixel, in float64 on ``device``, and the mask
    of the non-zero modes; ``core=True`` gives only the non-redundant
    ``[0, n//2]`` per axis (|k| is mirror symmetric per axis)."""
    k2 = None
    for axis, (n, dx) in enumerate(zip(shape, distances)):
        idx = torch.arange(n // 2 + 1 if core else n, dtype=torch.float64, device=device)
        fold = idx if core else torch.minimum(idx, n - idx)
        f = fold * (1.0 / (n * dx))
        f2 = (f * f).reshape((-1,) + (1,) * (len(shape) - axis - 1))
        k2 = f2 if k2 is None else k2 + f2
    return k2, k2 > 0


def _rel_log_k_grid(shape, distances, core: bool = False, device=None):
    """``(x, nonzero)``: ``x = log(|k| / k_min)`` per pixel (0 at the zero
    mode), the convention of the exact form's ``relative_log_mode_lengths``."""
    k2, nonzero = _k2_grid(shape, distances, core=core, device=device)
    kmin = min(1.0 / (n * dx) for n, dx in zip(shape, distances))
    x = torch.where(nonzero, 0.5 * torch.log(torch.where(nonzero, k2, 1.0)), 0.0)
    return torch.where(nonzero, x - float(np.log(kmin)), 0.0), nonzero


def _core_weights(shape):
    """Per-axis multiplicities of the core pixels under the mirror unfold
    (1 at the zero mode and an even axis's Nyquist mode, 2 elsewhere), as
    broadcastable float64 tensors."""
    out = []
    for axis, n in enumerate(shape):
        w = np.full(n // 2 + 1, 2.0)
        w[0] = 1.0
        if n % 2 == 0:
            w[-1] = 1.0
        out.append(torch.from_numpy(w.reshape((-1,) + (1,) * (len(shape) - axis - 1))))
    return out


def _attach_core_weights(module, shape, device):
    """Register :func:`_core_weights` as buffers ``core_weight_<axis>``."""
    for axis, w in enumerate(_core_weights(shape)):
        module.register_buffer(f"core_weight_{axis}", w.to(device))


def _apply_core_weights(module, x, ndim):
    """``x`` times the mirror multiplicities registered on ``module``."""
    for axis in range(ndim):
        x = x * getattr(module, f"core_weight_{axis}")
    return x


def _sum64(x):
    """``Σ x`` accumulated in float64, in ``x``'s dtype: the renormalisations
    sum up to 6.6 M core pixels."""
    return torch.sum(x, dtype=torch.float64).to(x.dtype)


def _max_rel_log_k(shape, distances):
    """Largest relative log mode length on a regular grid."""
    kmin = min(1.0 / (n * dx) for n, dx in zip(shape, distances))
    kmax2 = sum(((n // 2) / (n * dx)) ** 2 for n, dx in zip(shape, distances))
    return 0.5 * float(np.log(kmax2)) - float(np.log(kmin))


def make_grid(shape, distances, harmonic_type="fourier", mode_tables: bool = True):
    """The (position, harmonic) grid pair of a subgrid: a regular Cartesian
    grid (``"fourier"``) or the HEALPix sphere (``"spherical"``, ``shape``
    its nside).  ``mode_tables=False`` (the knot form) skips a regular
    grid's unique-|k| tables, which the per-pixel amplitude never reads and
    which cost tens of seconds of host time at 10⁸ pixels."""
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    ht = harmonic_type.lower()
    if ht == "spherical":
        if len(shape) != 1:
            raise ValueError("spherical `shape` is the single nside value")
        nside = shape[0]
        (m_length_idx, m_length, m_count), (lmax, mmax, size) = get_spherical_mode_distributor(nside)
        um, log_vol = _log_modes(m_length)
        harmonic_grid = LMGrid(lmax, mmax, (size,), m_length_idx, m_count, m_length, um, log_vol)
        return HEALPixGrid(nside, (12 * nside**2,), 4 * np.pi, harmonic_grid)
    if ht != "fourier":
        raise ValueError(f"invalid harmonic_type {harmonic_type!r}")
    distances = tuple(float(d) for d in np.broadcast_to(distances, (len(shape),)))
    totvol = float(np.prod(np.array(shape) * np.array(distances)))
    if not mode_tables:
        return RegularCartesianGrid(
            shape, totvol, distances, RegularFourierGrid(shape, None, None, None, None, None)
        )
    m_length_idx, m_length, m_count = get_fourier_mode_distributor(shape, distances)
    um, log_vol = _log_modes(m_length)
    harmonic_grid = RegularFourierGrid(
        shape=shape,
        power_distributor=m_length_idx,
        mode_multiplicity=m_count,
        mode_lengths=m_length,
        relative_log_mode_lengths=um,
        log_volume=log_vol,
    )
    return RegularCartesianGrid(shape, totvol, distances, harmonic_grid)


def _remove_slope(rel_log_mode_dist, x):
    sc = rel_log_mode_dist / rel_log_mode_dist[-1]
    return x - x[-1] * sc


# --- amplitude ---------------------------------------------------------------


class NonParametricAmplitude(Model):
    """Amplitude spectrum: power law in log|k| plus IWP deviations,
    normalised so that ``fluctuations`` sets the field's std.

    Exact form: calling it returns one value per unique mode, the zero mode
    set to the total volume.  Knot form (``n_mode_knots=K``): the deviations
    sit on K knots ``linspace(0, max log(|k|/k_min), K)`` and
    :meth:`expanded_normalized_core` evaluates the amplitude per core pixel;
    calling it returns the amplitude at the knots (a diagnostic).  The
    per-pixel grids are buffers that :meth:`attach_core_grid` builds on the
    model's device (``finalize`` calls it)."""

    def __init__(
        self,
        grid,
        fluctuations: Optional[Callable],
        loglogavgslope: Callable,
        flexibility: Optional[Callable] = None,
        asperity: Optional[Callable] = None,
        prefix: str = "",
        kind: str = "amplitude",
        n_mode_knots: Optional[int] = None,
    ):
        kind = kind.lower()
        if kind not in ("amplitude", "power"):
            raise ValueError(f"invalid kind {kind!r}")
        knots = None
        if n_mode_knots is not None:
            if not isinstance(grid, RegularCartesianGrid):
                raise TypeError("n_mode_knots requires a regular Cartesian grid")
            if n_mode_knots < 2:
                raise ValueError("need at least two spectral knots")
            knots = np.linspace(0.0, _max_rel_log_k(grid.shape, grid.distances), n_mode_knots)
            log_vol = np.diff(knots)
        else:
            log_vol = grid.harmonic_grid.log_volume
        slope = WrappedCall(loglogavgslope, name=prefix + "loglogavgslope")
        flu = (
            WrappedCall(fluctuations, name=prefix + "fluctuations")
            if fluctuations is not None
            else None
        )
        deviations = None
        if flexibility is not None and log_vol.size > 0:
            flx = WrappedCall(flexibility, name=prefix + "flexibility")
            asp = (
                WrappedCall(asperity, name=prefix + "asperity")
                if asperity is not None
                else None
            )
            deviations = IntegratedWienerProcess(
                np.zeros((2,)), flx, log_vol, name=prefix + "spectrum", asperity=asp
            )
        domain = {}
        for m in (flu, slope, deviations):
            if m is not None:
                domain.update(m.domain)
        super().__init__(domain=domain)
        self.grid = grid
        self.kind = kind
        self.loglogavgslope = slope
        self.fluctuations = flu
        self.deviations = deviations
        self.n_mode_knots = n_mode_knots
        if knots is not None:
            self.register_buffer("knots", torch.from_numpy(knots))
            return
        hg = grid.harmonic_grid
        self.register_buffer(
            "mode_multiplicity", torch.from_numpy(hg.mode_multiplicity.astype(np.float64))
        )
        self.register_buffer(
            "relative_log_mode_lengths",
            torch.from_numpy(np.asarray(hg.relative_log_mode_lengths, np.float64)),
        )

    # -- the knot form ------------------------------------------------------

    @property
    def per_pixel(self) -> bool:
        """Whether the amplitude is evaluated per core pixel (the knot form)
        rather than expanded from a unique-|k| table."""
        return self.n_mode_knots is not None

    def attach_core_grid(self, device) -> None:
        """Build the knot form's per-pixel buffers on ``device`` in float64
        (``.to(dtype)`` casts them): ``rel_log_k_core``, log(|k|/k_min) on
        the core; ``nonzero_core``, its mask of the non-zero modes; and
        ``core_weight_<axis>``, the mirror multiplicities per axis."""
        shape, distances = self.grid.shape, self.grid.distances
        x, nonzero = _rel_log_k_grid(shape, distances, core=True, device=device)
        self.register_buffer("rel_log_k_core", x)
        self.register_buffer("nonzero_core", nonzero)
        _attach_core_weights(self, shape, device)

    def _apply_core_weights(self, x):
        return _apply_core_weights(self, x, len(self.grid.shape))

    def _dev_knot_values(self, primals):
        """The deviation curve at the knots, its slope removed."""
        d = self.deviations(primals)[:, 0]
        return d - d[-1] * (self.knots / self.knots[-1])

    def _ln_deviations_at(self, x, primals):
        """The piecewise-linear deviation curve at log mode lengths ``x``:
        the relu-feature map of its slope changes."""
        d = self._dev_knot_values(primals)
        seg = torch.diff(d) / torch.diff(self.knots)
        coef = torch.cat((seg[:1], torch.diff(seg)))
        return PwlFeatures.apply(x, self.knots, coef)

    def _core_spectrum(self, primals):
        """``(flu, spectrum)``: exp of the log spectrum per core pixel, 0 at
        the zero mode."""
        flu = 1.0 if self.fluctuations is None else self.fluctuations(primals)
        x = self.rel_log_k_core
        ln_spectrum = self.loglogavgslope(primals) * x
        if self.deviations is not None:
            ln_spectrum = ln_spectrum + self._ln_deviations_at(x, primals)
        return flu, torch.where(self.nonzero_core, torch.exp(ln_spectrum), 0.0)

    def _normalization(self, spectrum):
        """The norm of the non-zero-mode power over the full grid, summed on
        the core with the mirror multiplicities."""
        power = spectrum**2 if self.kind == "amplitude" else spectrum
        return torch.sqrt(_sum64(self._apply_core_weights(power)))

    def expanded_normalized_core(self, primals, azm):
        """The normalised amplitude divided by ``azm`` per pixel of the
        non-redundant |k| core, the zero mode set to the total volume; the
        full grid is its mirror unfold."""
        flu, spectrum = self._core_spectrum(primals)
        totvol = self.grid.total_volume
        amplitude = flu * (totvol / self._normalization(spectrum))
        amplitude = amplitude * (spectrum if self.kind == "amplitude" else torch.sqrt(spectrum))
        return torch.where(self.nonzero_core, amplitude / azm, totvol)

    def expanded_normalized(self, primals, azm):
        """:meth:`expanded_normalized_core` on the full harmonic grid."""
        return mirror_unfold(self.expanded_normalized_core(primals, azm), self.grid.shape)

    # -- calling it -----------------------------------------------------------

    def forward(self, primals):
        if self.n_mode_knots is not None:
            return self._at_knots(primals)
        flu = 1.0 if self.fluctuations is None else self.fluctuations(primals)
        totvol = self.grid.total_volume
        rel = self.relative_log_mode_lengths
        mm = self.mode_multiplicity
        ln_spectrum = self.loglogavgslope(primals) * rel
        if self.deviations is not None:
            twolog = self.deviations(primals)
            # prepend the (fixed) zero mode, keep the integrated coordinate
            twolog = torch.cat((twolog.new_zeros(1), twolog[:, 0]))
            ln_spectrum = ln_spectrum + _remove_slope(rel, twolog)
        spectrum = torch.exp(ln_spectrum)
        # normalise out the non-zero-mode power, then scale by fluctuations
        if self.kind == "amplitude":
            norm = torch.sqrt(_sum64(mm[1:] * spectrum[1:] ** 2))
            amplitude = flu * (totvol / norm) * spectrum
        else:
            norm = torch.sqrt(_sum64(mm[1:] * spectrum[1:]))
            amplitude = flu * (totvol / norm) * torch.sqrt(spectrum)
        return torch.cat((amplitude.new_full((1,), totvol), amplitude[1:]))

    def _at_knots(self, primals):
        """The knot form's diagnostic: the normalised amplitude at the knots
        (the normalisation still integrates over the full grid)."""
        flu, spec_grid = self._core_spectrum(primals)
        ln_knots = self.loglogavgslope(primals) * self.knots
        if self.deviations is not None:
            ln_knots = ln_knots + self._dev_knot_values(primals)
        spectrum = torch.exp(ln_knots)
        scale = flu * (self.grid.total_volume / self._normalization(spec_grid))
        return scale * (spectrum if self.kind == "amplitude" else torch.sqrt(spectrum))


class MaternAmplitude(Model):
    """Matérn-kernel amplitude spectrum, ``scale · (1 + (|k|/cutoff)²)^(slope/4)``,
    optionally renormalised so that its non-zero-mode power is the total
    volume.  Table form: calling it gives one value per unique mode, the
    zero mode set to the total volume (expanded by K1, as the exact
    non-parametric form).  ``pixel_expansion=True``: no table;
    :meth:`expanded_normalized_core` evaluates the spectrum per pixel of
    the |k| core, from float64 buffers that :meth:`attach_core_grid` builds
    on the model's device (``finalize`` calls it), and calling it gives the
    spectrum at 64 log-spaced |k| (a diagnostic)."""

    def __init__(
        self,
        grid,
        scale: Optional[Callable],
        cutoff: Callable,
        loglogslope: Callable,
        renormalize_amplitude: bool,
        prefix: str = "",
        kind: str = "amplitude",
        pixel_expansion: bool = False,
    ):
        kind = kind.lower()
        if kind not in ("amplitude", "power"):
            raise ValueError(f"invalid kind {kind!r}")
        if pixel_expansion and not isinstance(grid, RegularCartesianGrid):
            raise TypeError("pixel_expansion requires a regular Cartesian grid")
        cutoff = WrappedCall(cutoff, name=prefix + "cutoff")
        loglogslope = WrappedCall(loglogslope, name=prefix + "loglogslope")
        scale = WrappedCall(scale, name=prefix + "scale") if scale is not None else None
        domain = {}
        for m in (scale, cutoff, loglogslope):
            if m is not None:
                domain.update(m.domain)
        super().__init__(domain=domain)
        self.grid = grid
        self.kind = kind
        self.pixel_mode = bool(pixel_expansion)
        self.scale, self.cutoff, self.loglogslope = scale, cutoff, loglogslope
        self.renormalize_amplitude = bool(renormalize_amplitude)
        if not self.pixel_mode:
            hg = grid.harmonic_grid
            self.register_buffer("mode_lengths", torch.from_numpy(
                np.asarray(hg.mode_lengths, np.float64)))
            self.register_buffer("mode_multiplicity", torch.from_numpy(
                hg.mode_multiplicity.astype(np.float64)))

    @property
    def per_pixel(self) -> bool:
        """Whether the amplitude is evaluated per core pixel."""
        return self.pixel_mode

    def attach_core_grid(self, device) -> None:
        """Build the pixel form's buffers on ``device`` in float64 (cast by
        ``.to(dtype)``): ``k2_core``, |k|² on the core, ``nonzero_core`` and
        the mirror multiplicities ``core_weight_<axis>``."""
        k2, nonzero = _k2_grid(self.grid.shape, self.grid.distances, core=True, device=device)
        self.register_buffer("k2_core", k2)
        self.register_buffer("nonzero_core", nonzero)
        _attach_core_weights(self, self.grid.shape, device)

    def _hyper(self, primals):
        scl = 1.0 if self.scale is None else self.scale(primals)
        return scl, self.cutoff(primals), self.loglogslope(primals)

    def _core_spectrum(self, ctf, slp):
        ln_spectrum = 0.25 * slp * torch.log1p(self.k2_core / ctf**2)
        return torch.where(self.nonzero_core, torch.exp(ln_spectrum), 0.0)

    def _norm(self, power_sum):
        """The renormalisation ``√(Σ power) / √V`` (1 without it)."""
        if not self.renormalize_amplitude:
            return 1.0
        return torch.sqrt(power_sum) / float(np.sqrt(self.grid.total_volume))

    def _power_sum(self, spectrum, weighted):
        power = spectrum**2 if self.kind == "amplitude" else spectrum
        return _sum64(weighted(power))

    def _scaled(self, scl, norm, spectrum):
        if self.kind == "power":
            spectrum = torch.sqrt(spectrum)
        return scl * (float(np.sqrt(self.grid.total_volume)) / norm) * spectrum

    def expanded_normalized_core(self, primals, azm):
        """The normalised amplitude divided by ``azm`` per pixel of the |k|
        core, the zero mode set to the total volume; the full grid is its
        mirror unfold."""
        scl, ctf, slp = self._hyper(primals)
        spectrum = self._core_spectrum(ctf, slp)
        norm = 1.0
        if self.renormalize_amplitude:
            norm = self._norm(self._power_sum(
                spectrum, partial(_apply_core_weights, self, ndim=len(self.grid.shape))))
        spectrum = self._scaled(scl, norm, spectrum)
        return torch.where(self.nonzero_core, spectrum / azm, self.grid.total_volume)

    def expanded_normalized(self, primals, azm):
        """:meth:`expanded_normalized_core` on the full harmonic grid."""
        return mirror_unfold(self.expanded_normalized_core(primals, azm), self.grid.shape)

    def forward(self, primals):
        scl, ctf, slp = self._hyper(primals)
        if self.pixel_mode:
            kmin = min(1.0 / (n * dx) for n, dx in zip(self.grid.shape, self.grid.distances))
            xmax = _max_rel_log_k(self.grid.shape, self.grid.distances)
            ref = self.k2_core
            k = kmin * torch.exp(torch.linspace(0.0, xmax, 64, dtype=ref.dtype, device=ref.device))
        else:
            k = self.mode_lengths
        spectrum = torch.exp(0.25 * slp * torch.log1p((k / ctf) ** 2))
        norm = 1.0
        if self.renormalize_amplitude:
            if self.pixel_mode:
                weighted = partial(_apply_core_weights, self, ndim=len(self.grid.shape))
                norm = self._norm(self._power_sum(self._core_spectrum(ctf, slp), weighted))
            else:
                mm = self.mode_multiplicity
                norm = self._norm(self._power_sum(spectrum[1:], lambda p: mm[1:] * p))
        spectrum = self._scaled(scl, norm, spectrum)
        if self.pixel_mode:
            return spectrum
        return torch.cat((spectrum.new_full((1,), self.grid.total_volume), spectrum[1:]))


# --- the finalized model -----------------------------------------------------


class _Hartley(torch.nn.Module):
    """The Hartley transform over the axes of one regular subgrid."""

    def __init__(self, axes):
        super().__init__()
        self.axes = axes

    def forward(self, x):
        return hartley(x, axes=self.axes)


class _PencilHartley(torch.nn.Module):
    """The Hartley transform of a row-sharded field over its ``nd`` axes."""

    def __init__(self, axis, nd):
        super().__init__()
        self.axis, self.nd = axis, nd

    def forward(self, x):
        from ..parallel.fft import PencilHartley

        return PencilHartley.apply(x, self.axis, self.nd)


class CorrelatedField(Model):
    """ξ coloured by the outer product of the expanded amplitudes, mapped
    through the harmonic transform(s), plus the offset.  ``indexes`` holds
    the mode index of each table-form amplitude, in order; a per-pixel
    amplitude (:attr:`per_pixel`: the knot form, a Matérn pixel form) needs
    none.  With ``field_mesh`` the field is row-sharded over its axis
    ``field_axis`` (``axis``, the :class:`~..parallel.fft.MeshAxis`): ξ and
    the output are the rank's rows."""

    def __init__(
        self, *, amplitudes, indexes, full_shapes, azm, offset_mean, xi_key,
        harmonic_transforms, domain, field_mesh=None, field_axis="fx", axis=None,
    ):
        super().__init__(domain=domain)
        self.amplitudes = torch.nn.ModuleList(amplitudes)
        self.indexes = torch.nn.ModuleList(indexes)
        self.full_shapes = tuple(full_shapes)
        self.azm = azm
        self.offset_mean = offset_mean
        self.xi_key = xi_key
        self.harmonic_volumes = tuple(dvol for dvol, _ in harmonic_transforms)
        self.harmonic_transforms = torch.nn.ModuleList(ht for _, ht in harmonic_transforms)
        self.field_mesh, self.field_axis, self.axis = field_mesh, field_axis, axis
        if axis is not None:  # K2r's CSR of the rank's rows, built once; it follows the index
            shapes = [f for a, f in zip(self.amplitudes, self.full_shapes) if not a.per_pixel]
            for index, fshape in zip(self.indexes, shapes):
                index.row_tables(fshape, self.rows)

    @property
    def rows(self):
        """``(lo, n)``: the rows of the leading axis this rank holds (all of
        them without a field mesh)."""
        n0 = self.full_shapes[0][0]
        if self.axis is None:
            return 0, n0
        n = n0 // self.axis.size
        return self.axis.rank * n, n

    def position_sharding(self, batch_ndim: int = 0):
        """The placements of a position (:class:`~..parallel.NamedSharding`
        by key): ξ split along its leading field axis, after ``batch_ndim``
        batch axes, over the field axis; every other leaf replicated."""
        from ..parallel.mesh import NamedSharding

        if self.field_mesh is None:
            raise ValueError("model was finalized without a field mesh")
        out = {k: NamedSharding(self.field_mesh, ()) for k in self.domain}
        out[self.xi_key] = NamedSharding(self.field_mesh, (None,) * batch_ndim + (self.field_axis,))
        return out

    def _replicated(self, p):
        """``p`` with its replicated leaves entering rank-local work: their
        cotangents are summed over the field axis."""
        if self.axis is None:
            return p
        from ..parallel.collectives import replicate

        return {k: v if k == self.xi_key or k not in self.domain else replicate(v, self.axis.group)
                for k, v in p.items()}

    def harmonic_amplitude(self, p):
        """The amplitude that colours ξ on the harmonic grid: ``azm`` times
        the outer product of the expanded amplitudes (for
        :func:`~nifty_tpu_torch.adjust_variances.adjust_variances`); the
        rank's rows of it on a field mesh."""
        p = self._replicated(p)
        azm = self.azm(p)
        outer = None
        indexes = iter(self.indexes)
        rows = None if self.axis is None else self.rows
        for amp, fshape in zip(self.amplitudes, self.full_shapes):
            if amp.per_pixel:
                # evaluated per pixel of the |k| core: no table, no gather
                ea = mirror_unfold(amp.expanded_normalized_core(p, azm), fshape, rows)
            else:
                a = amp(p)
                # divide the degenerate zero mode out of each amplitude
                a = torch.cat((a[:1], a[1:] * (1.0 / azm)))
                # the index covers the (n//2+1)^d core, |k| being mirror
                # symmetric per axis; K1 expands the table onto the full
                # grid (K2 is its adjoint), K1r onto the rank's rows
                index = next(indexes)
                ea = (mode_expand_grid(a, index, fshape) if rows is None
                      else mode_expand_grid_rows(a, index, fshape, rows))
            # order matters: it must match the excitation axes
            outer = ea if outer is None else torch.tensordot(outer, ea, dims=0)
        return azm * outer

    @tracing.span("cf.forward")
    def forward(self, p):
        out = self.harmonic_amplitude(p) * p[self.xi_key]
        for dvol, ht in zip(self.harmonic_volumes, self.harmonic_transforms):
            out = dvol * ht(out)
        out = self.offset_mean + out
        if self.axis is None:
            return out
        from ..parallel.collectives import note_split

        return note_split(out, rows=True)  # the rank's rows


# --- the maker ---------------------------------------------------------------


def _parse_prior(value, default_prior, what):
    if isinstance(value, (tuple, list)):
        return default_prior(*value)
    if callable(value):
        return value
    raise TypeError(f"invalid `{what}` specified; got {type(value)}")


class CorrelatedFieldMaker:
    """Builder of correlated-field models: :meth:`add_fluctuations` once per
    subgrid (their spectra combine as an outer product),
    :meth:`set_amplitude_total_offset`, then :meth:`finalize`."""

    def __init__(self, prefix: str):
        self._azm = None
        self._offset_mean = None
        self._fluctuations = []
        self._target_grids = []
        self._parameter_tree = {}
        self._prefix = prefix

    def add_fluctuations(
        self,
        shape,
        distances,
        fluctuations,
        loglogavgslope,
        flexibility=None,
        asperity=None,
        prefix: str = "",
        harmonic_type: str = "fourier",
        non_parametric_kind: str = "amplitude",
        n_mode_knots: Optional[int] = None,
    ):
        """Add a non-parametric correlation structure on a subgrid: the
        exact unique-|k| spectrum, or with ``n_mode_knots=K`` its K-knot
        form evaluated per pixel."""
        grid = make_grid(shape, distances, harmonic_type, mode_tables=n_mode_knots is None)
        flx = (
            _parse_prior(flexibility, lognormal_prior, "flexibility")
            if flexibility is not None
            else None
        )
        asp = (
            _parse_prior(asperity, lognormal_prior, "asperity")
            if asperity is not None
            else None
        )
        npa = NonParametricAmplitude(
            grid=grid,
            fluctuations=_parse_prior(fluctuations, lognormal_prior, "fluctuations"),
            loglogavgslope=_parse_prior(loglogavgslope, normal_prior, "loglogavgslope"),
            flexibility=flx,
            asperity=asp,
            prefix=self._prefix + prefix,
            kind=non_parametric_kind,
            n_mode_knots=n_mode_knots,
        )
        self._fluctuations.append(npa)
        self._target_grids.append(grid)
        self._parameter_tree.update(npa.domain)

    def add_fluctuations_matern(
        self,
        shape,
        distances,
        scale,
        cutoff,
        loglogslope,
        renormalize_amplitude: bool,
        prefix: str = "",
        harmonic_type: str = "fourier",
        non_parametric_kind: str = "amplitude",
        pixel_expansion: bool = False,
    ):
        """Add a Matérn-kernel correlation structure on a subgrid: its
        spectrum on the unique-|k| table, or with ``pixel_expansion=True``
        per pixel of the |k| core (no table)."""
        grid = make_grid(shape, distances, harmonic_type, mode_tables=not pixel_expansion)
        ma = MaternAmplitude(
            grid=grid,
            scale=_parse_prior(scale, lognormal_prior, "scale"),
            cutoff=_parse_prior(cutoff, lognormal_prior, "cutoff"),
            loglogslope=_parse_prior(loglogslope, normal_prior, "loglogslope"),
            renormalize_amplitude=renormalize_amplitude,
            prefix=self._prefix + prefix,
            kind=non_parametric_kind,
            pixel_expansion=pixel_expansion,
        )
        self._fluctuations.append(ma)
        self._target_grids.append(grid)
        self._parameter_tree.update(ma.domain)

    def set_amplitude_total_offset(self, offset_mean, offset_std):
        """Set the field's global offset and the zero-mode prior."""
        self._offset_mean = offset_mean
        zm = offset_std
        if not callable(zm):
            if zm is None or len(zm) != 2:
                raise TypeError(f"invalid `offset_std` {offset_std!r}")
            zm = lognormal_prior(*zm)
        self._azm = WrappedCall(zm, name=self._prefix + "zeromode")
        self._parameter_tree[self._prefix + "zeromode"] = ShapeWithDtype(())

    def finalize(self, device=None, dtype=torch.float32, field_mesh=None,
                 field_axis: str = "fx") -> CorrelatedField:
        """Assemble the model with its floating buffers in ``dtype`` on
        ``device`` (the CUDA card by default; raises without one).

        With ``field_mesh`` (a ``DeviceMesh`` with the axis ``field_axis``)
        the model runs row-sharded over that axis: ξ and the output are the
        rank's rows of the leading axis, the Hartley the pencil transform
        (see the module's docstring).  It takes one regular Cartesian
        subgrid of ndim >= 2 whose two leading axes the axis size divides
        (and, for a float32 2-D grid that K3 + K4r take, whose axis size
        keeps their layout: :func:`~..parallel.fft.uses_kernels`);
        ``model.position_sharding()`` places positions."""
        if self._azm is None:
            raise RuntimeError("set_amplitude_total_offset must be called first")
        device = _device.resolve(device)
        axis = None
        if field_mesh is not None:
            if len(self._target_grids) != 1 or not isinstance(
                self._target_grids[0], RegularCartesianGrid
            ):
                raise ValueError("field_mesh requires a single regular-Cartesian subgrid")
            if len(self._target_grids[0].shape) < 2:
                raise ValueError("field_mesh requires an ndim >= 2 grid")
            from ..parallel.fft import mesh_axis, uses_kernels

            axis = mesh_axis(field_mesh, field_axis)
            s0, s1 = self._target_grids[0].shape[:2]
            if s0 % axis.size or s1 % axis.size:
                raise ValueError(
                    "the two leading grid axes must be divisible by the"
                    f" field-mesh axis size {axis.size}"
                )
            # raises for a float32 grid in K3 + K4r's domain whose axis size breaks them
            uses_kernels(self._target_grids[0].harmonic_grid.shape, axis.size, dtype)
            if field_mesh.device_type != device.type:
                raise ValueError(
                    f"a field mesh on {field_mesh.device_type} for a model on {device.type}")
        harmonic_transforms = []
        excitation_shape = ()
        indexes = []
        # copies: `.to` moves modules in place, and a maker may be finalized
        # more than once (on the card and on the CPU, say)
        amplitudes = copy.deepcopy(self._fluctuations)
        for amp, g in zip(amplitudes, self._target_grids):
            sub_shp = g.harmonic_grid.shape
            excitation_shape += sub_shp
            n = len(excitation_shape)
            if isinstance(g, HEALPixGrid):
                hg = g.harmonic_grid
                trafo = HealpixSynthesis(g.nside, hg.lmax, hg.mmax, axis=n - 1)
            elif axis is not None:
                trafo = _PencilHartley(axis, len(sub_shp))
            else:
                trafo = _Hartley(tuple(range(n - len(sub_shp), n)))
            harmonic_transforms.append((1.0 / g.total_volume, trafo))
            if amp.per_pixel:
                amp.attach_core_grid(device)
                continue
            pd = np.asarray(g.harmonic_grid.power_distributor, dtype=np.int32)
            if isinstance(g, RegularCartesianGrid):  # |k| is mirror symmetric per axis
                pd = pd[tuple(slice(0, h) for h in _core_shape(pd.shape))]
            packed, layout = build_expand_layout(pd, int(g.harmonic_grid.mode_lengths.size))
            indexes.append(ExpandIndex(packed, layout))
        xi_key = self._prefix + "xi"
        self._parameter_tree[xi_key] = ShapeWithDtype(excitation_shape)
        return CorrelatedField(
            amplitudes=amplitudes,
            indexes=indexes,
            full_shapes=[g.harmonic_grid.shape for g in self._target_grids],
            azm=copy.deepcopy(self._azm),
            offset_mean=self._offset_mean,
            xi_key=xi_key,
            harmonic_transforms=harmonic_transforms,
            domain=dict(self._parameter_tree),
            field_mesh=field_mesh,
            field_axis=field_axis,
            axis=axis,
        ).to(device=device, dtype=dtype)


def density_estimator(
    shape,
    *,
    distances=None,
    pad: float = 1.0,
    cf_fluctuations=None,
    azm_uniform=(1e-4, 1.0),
    prefix: str = "",
    device=None,
    dtype=torch.float32,
):
    """The exponentiated Matérn correlated field on a grid padded by ``pad``
    (a factor of each axis), the standard non-parametric density prior;
    its zero mode has a uniform prior, so the scale comes from the data.
    Returns ``(model, padded_shape)``: evaluate the model and slice
    ``[tuple(slice(0, s) for s in shape)]`` for the unpadded density.  The
    model holds its field as ``correlated_field``; ``device`` and ``dtype``
    go to ``finalize``."""
    from ..num.stats_distributions import uniform_prior

    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    distances = tuple(1.0 / s for s in shape) if distances is None else distances
    distances = tuple(np.broadcast_to(distances, (len(shape),)))
    if cf_fluctuations is None:
        cf_fluctuations = dict(scale=(0.5, 0.3), cutoff=(4.0, 3.0), loglogslope=(-6.0, 3.0))
    pshape = tuple(int(np.ceil((1.0 + pad) * s)) for s in shape)
    cfm = CorrelatedFieldMaker(prefix)
    cfm.add_fluctuations_matern(pshape, distances=distances, renormalize_amplitude=False,
                                **cf_fluctuations)
    cfm.set_amplitude_total_offset(offset_mean=0.0, offset_std=uniform_prior(*azm_uniform))
    cf = cfm.finalize(device=device, dtype=dtype)
    model = ChainModel(torch.exp, cf)
    model.correlated_field = cf
    return model, pshape
