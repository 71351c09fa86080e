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

Spherical grids, Matérn amplitudes and field-sharded execution are not
part of this port yet.
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
from ..ops.cuda_expand import mirror_unfold
from ..ops.fft import hartley
from ..ops.mode_expand import ExpandIndex, build_expand_layout, mode_expand_grid
from ..ops.pwl import PwlFeatures
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


def _max_rel_log_k(shape, distances):
    """Largest relative log mode length on a regular grid."""
    kmin = min(1.0 / (n * dx) for n, dx in zip(shape, distances))
    kmax2 = sum(((n // 2) / (n * dx)) ** 2 for n, dx in zip(shape, distances))
    return 0.5 * float(np.log(kmax2)) - float(np.log(kmin))


def make_grid(shape, distances, harmonic_type="fourier", mode_tables: bool = True):
    """The (position, harmonic) grid pair of a regular Cartesian subgrid.
    ``mode_tables=False`` (the knot form) skips the unique-|k| tables, which
    the per-pixel amplitude never reads and which cost tens of seconds of
    host time at 10⁸ pixels."""
    if harmonic_type.lower() != "fourier":
        raise NotImplementedError("only regular Fourier grids are ported")
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
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

    def attach_core_grid(self, device) -> None:
        """Build the knot form's per-pixel buffers on ``device`` in float64
        (``.to(dtype)`` casts them): ``rel_log_k_core``, log(|k|/k_min) on
        the core; ``nonzero_core``, its mask of the non-zero modes; and
        ``core_weight_<axis>``, the mirror multiplicities per axis."""
        shape, distances = self.grid.shape, self.grid.distances
        x, nonzero = _rel_log_k_grid(shape, distances, core=True, device=device)
        self.register_buffer("rel_log_k_core", x)
        self.register_buffer("nonzero_core", nonzero)
        for axis, w in enumerate(_core_weights(shape)):
            self.register_buffer(f"core_weight_{axis}", w.to(device))

    def _apply_core_weights(self, x):
        for axis in range(len(self.grid.shape)):
            x = x * getattr(self, f"core_weight_{axis}")
        return x

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
        return torch.sqrt(torch.sum(self._apply_core_weights(power)))

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
            norm = torch.sqrt(torch.sum(mm[1:] * spectrum[1:] ** 2))
            amplitude = flu * (totvol / norm) * spectrum
        else:
            norm = torch.sqrt(torch.sum(mm[1:] * spectrum[1:]))
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


# --- the finalized model -----------------------------------------------------


class CorrelatedField(Model):
    """ξ coloured by the outer product of the expanded amplitudes, mapped
    through the harmonic transform(s), plus the offset.  ``indexes`` holds
    the mode index of each exact-form amplitude, in order; a knot-form
    amplitude needs none."""

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
        indexes = iter(self.indexes)
        for amp, fshape in zip(self.amplitudes, self.full_shapes):
            if amp.n_mode_knots is not None:
                # evaluated per pixel of the |k| core: no table, no gather
                ea = mirror_unfold(amp.expanded_normalized_core(p, azm), fshape)
            else:
                a = amp(p)
                # divide the degenerate zero mode out of each amplitude
                a = torch.cat((a[:1], a[1:] * (1.0 / azm)))
                # the index covers the (n//2+1)^d core, |k| being mirror
                # symmetric per axis; K1 expands the table onto the full
                # grid (K2 is its adjoint)
                ea = mode_expand_grid(a, next(indexes), fshape)
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
        # copies: `.to` moves modules in place, and a maker may be finalized
        # more than once (on the card and on the CPU, say)
        amplitudes = copy.deepcopy(self._fluctuations)
        for amp, g in zip(amplitudes, self._target_grids):
            sub_shp = g.harmonic_grid.shape
            excitation_shape += sub_shp
            n = len(excitation_shape)
            axes = tuple(range(n - len(sub_shp), n))
            harmonic_transforms.append((1.0 / g.total_volume, partial(hartley, axes=axes)))
            if amp.n_mode_knots is not None:
                amp.attach_core_grid(device)
                continue
            pd = np.asarray(g.harmonic_grid.power_distributor, dtype=np.int32)
            core = pd[tuple(slice(0, h) for h in _core_shape(pd.shape))]
            packed, layout = build_expand_layout(core, int(g.harmonic_grid.mode_lengths.size))
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
        ).to(device=device, dtype=dtype)
