"""Correlated-field GP prior, exact-spectrum form (counterpart of
``nifty_tpu/models/correlated_field.py``).

A standard-normal excitation ξ in harmonic space is coloured by an
amplitude spectrum (a power law in log|k| plus integrated-Wiener-process
deviations, one value per unique |k|), scaled by a global zero mode and
mapped to position space by the Hartley transform.  The mode binning is
computed with numpy when the model is built; at run time only the
expansion of the amplitude table onto the full grid (K1, its adjoint K2)
and the Hartley (K3 + K4) touch the grid.

The 64-knot form (``n_mode_knots``), spherical grids, Matérn amplitudes
and field-sharded execution are not part of this port yet.
"""

from __future__ import annotations

import copy
from collections import namedtuple
from functools import partial
from typing import Callable, Optional

import numpy as np
import torch

from .. import device as _device
from ..model import Model, WrappedCall
from ..num.stats_distributions import lognormal_prior, normal_prior
from ..ops.fft import hartley
from ..ops.mode_expand import ExpandIndex, build_expand_layout, mode_expand_grid
from ..utils.tree import ShapeWithDtype
from .gauss_markov import IntegratedWienerProcess

__all__ = [
    "CorrelatedField",
    "CorrelatedFieldMaker",
    "NonParametricAmplitude",
    "RegularCartesianGrid",
    "RegularFourierGrid",
    "get_fourier_mode_distributor",
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


# --- grids -------------------------------------------------------------------

RegularCartesianGrid = namedtuple(
    "RegularCartesianGrid",
    ("shape", "total_volume", "distances", "harmonic_grid"),
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


def make_grid(shape, distances, harmonic_type="fourier"):
    """The (position, harmonic) grid pair of a regular Cartesian subgrid."""
    if harmonic_type.lower() != "fourier":
        raise NotImplementedError("only regular Fourier grids are ported")
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    distances = tuple(float(d) for d in np.broadcast_to(distances, (len(shape),)))
    totvol = float(np.prod(np.array(shape) * np.array(distances)))
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
    """Amplitude spectrum on the unique |k|: power law in log|k| plus IWP
    deviations, normalised so that ``fluctuations`` sets the field's std.
    Returns one value per unique mode, the zero mode set to the total
    volume."""

    def __init__(
        self,
        grid,
        fluctuations: Optional[Callable],
        loglogavgslope: Callable,
        flexibility: Optional[Callable] = None,
        asperity: Optional[Callable] = None,
        prefix: str = "",
        kind: str = "amplitude",
    ):
        kind = kind.lower()
        if kind not in ("amplitude", "power"):
            raise ValueError(f"invalid kind {kind!r}")
        hg = grid.harmonic_grid
        log_vol = hg.log_volume
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
        self.register_buffer(
            "mode_multiplicity", torch.from_numpy(hg.mode_multiplicity.astype(np.float64))
        )
        self.register_buffer(
            "relative_log_mode_lengths",
            torch.from_numpy(np.asarray(hg.relative_log_mode_lengths, np.float64)),
        )

    def forward(self, primals):
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
            norm = torch.sqrt(torch.sum(mm[1:] * spectrum[1:] ** 2))
            amplitude = flu * (totvol / norm) * spectrum
        else:
            norm = torch.sqrt(torch.sum(mm[1:] * spectrum[1:]))
            amplitude = flu * (totvol / norm) * torch.sqrt(spectrum)
        return torch.cat((amplitude.new_full((1,), totvol), amplitude[1:]))


# --- the finalized model -----------------------------------------------------


class CorrelatedField(Model):
    """ξ coloured by the outer product of the expanded amplitudes, mapped
    through the harmonic transform(s), plus the offset."""

    def __init__(
        self, *, amplitudes, indexes, full_shapes, azm, offset_mean, xi_key,
        harmonic_transforms, domain,
    ):
        super().__init__(domain=domain)
        self.amplitudes = torch.nn.ModuleList(amplitudes)
        self.indexes = torch.nn.ModuleList(indexes)
        self.full_shapes = tuple(full_shapes)
        self.azm = azm
        self.offset_mean = offset_mean
        self.xi_key = xi_key
        self.harmonic_transforms = tuple(harmonic_transforms)

    def forward(self, p):
        azm = self.azm(p)
        outer = None
        for amp, index, fshape in zip(self.amplitudes, self.indexes, self.full_shapes):
            a = amp(p)
            # divide the degenerate zero mode out of each amplitude
            a = torch.cat((a[:1], a[1:] * (1.0 / azm)))
            # the index covers the (n//2+1)^d core, |k| being mirror
            # symmetric per axis; K1 expands the table onto the full grid
            # (K2 is its adjoint)
            ea = mode_expand_grid(a, index, fshape)
            # order matters: it must match the excitation axes
            outer = ea if outer is None else torch.tensordot(outer, ea, dims=0)
        out = azm * outer * p[self.xi_key]
        for dvol, ht in self.harmonic_transforms:
            out = dvol * ht(out)
        return self.offset_mean + out


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
        """Add a non-parametric correlation structure on a subgrid, with the
        exact unique-|k| spectrum."""
        if n_mode_knots is not None:
            raise NotImplementedError("the n_mode_knots form is not ported yet")
        grid = make_grid(shape, distances, harmonic_type)
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
        )
        self._fluctuations.append(npa)
        self._target_grids.append(grid)
        self._parameter_tree.update(npa.domain)

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

    def finalize(self, device=None, dtype=torch.float32) -> CorrelatedField:
        """Assemble the model with its floating buffers in ``dtype`` on
        ``device`` (the CUDA card by default; raises without one)."""
        if self._azm is None:
            raise RuntimeError("set_amplitude_total_offset must be called first")
        device = _device.resolve(device)
        harmonic_transforms = []
        excitation_shape = ()
        indexes = []
        for g in self._target_grids:
            sub_shp = g.harmonic_grid.shape
            excitation_shape += sub_shp
            n = len(excitation_shape)
            axes = tuple(range(n - len(sub_shp), n))
            harmonic_transforms.append((1.0 / g.total_volume, partial(hartley, axes=axes)))
            pd = np.asarray(g.harmonic_grid.power_distributor, dtype=np.int32)
            core = pd[tuple(slice(0, h) for h in _core_shape(pd.shape))]
            packed, layout = build_expand_layout(core, int(g.harmonic_grid.mode_lengths.size))
            indexes.append(ExpandIndex(packed, layout))
        xi_key = self._prefix + "xi"
        self._parameter_tree[xi_key] = ShapeWithDtype(excitation_shape)
        # copies: `.to` moves modules in place, and a maker may be finalized
        # more than once (on the card and on the CPU, say)
        return CorrelatedField(
            amplitudes=copy.deepcopy(self._fluctuations),
            indexes=indexes,
            full_shapes=[g.harmonic_grid.shape for g in self._target_grids],
            azm=copy.deepcopy(self._azm),
            offset_mean=self._offset_mean,
            xi_key=xi_key,
            harmonic_transforms=harmonic_transforms,
            domain=dict(self._parameter_tree),
        ).to(device=device, dtype=dtype)
