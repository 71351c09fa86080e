"""Empirical (binned) power spectra of fields on regular grids (counterpart
of ``nifty_tpu/empirical_power_spectrum.py``).

|FFT|² over the chosen axes, optionally Hann-windowed for non-periodic
data, averaged in logarithmic |k| shells.  The FFT and the shell sums run
on the field's device; the bin of every mode is computed once with numpy,
as in the JAX package.  The shells are summed in a fixed order (the modes
sorted by bin once, then a CSR segment sum), so a spectrum has the same
bits on every call: ``index_add_``'s float atomics on the card would
reorder the sums.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch

from . import device as _device

__all__ = ["compute_empirical_power_spectrum"]


def _hann_window(shape, axes):
    """The separable Hann window over ``axes`` (numpy's ``hanning``, the
    symmetric window; ``torch.hann_window`` is periodic by default)."""
    window = np.ones(shape)
    for ax in axes:
        bshape = [1] * len(shape)
        bshape[ax] = shape[ax]
        window = window * np.hanning(shape[ax]).reshape(bshape)
    return window


def compute_empirical_power_spectrum(
    field,
    distances: Union[float, Tuple[float, ...]],
    axes: Optional[Union[int, Tuple[int, ...]]] = None,
    use_window: bool = False,
    n_bins: Optional[int] = 128,
    *,
    device=None,
):
    """Average empirical power spectrum of ``field`` over ``axes``.

    Returns ``(ps, k_bin_centers)``, both tensors on the field's device
    (a numpy ``field`` goes to ``device``, the CUDA card by default); the
    axes not consumed stay as leading axes of ``ps``, and only shells that
    hold a mode are returned.  Set ``use_window=True`` for non-periodic
    fields.
    """
    if not isinstance(field, torch.Tensor):
        field = torch.as_tensor(np.asarray(field), device=_device.resolve(device))
    if axes is None:
        axes = tuple(range(field.ndim))
    elif isinstance(axes, int):
        axes = (axes,)
    axes = tuple(a % field.ndim for a in axes)
    if isinstance(distances, (int, float)):
        dist = (float(distances),) * len(axes)
    else:
        dist = tuple(float(d) for d in distances)
        if len(dist) != len(axes):
            raise ValueError("len(distances) must match the number of axes")

    w_correction = 1.0
    if use_window:
        window = _hann_window(tuple(field.shape), axes)
        field = field * torch.as_tensor(window, dtype=field.real.dtype, device=field.device)
        w_correction = float(np.mean(window**2))
    power = torch.fft.fftn(field, dim=axes).abs() ** 2 / w_correction

    # the bin of every mode (numpy; the shapes and distances are static)
    shp = [field.shape[ax] for ax in axes]
    lengths = np.array([n * d for n, d in zip(shp, dist)])
    k_bins = np.geomspace(1.0 / lengths.max(), 1.0 / min(dist), n_bins + 1)
    k_centers = np.sqrt(k_bins[1:] * k_bins[:-1])
    kg = np.meshgrid(*(np.fft.fftfreq(n, d=d) for n, d in zip(shp, dist)), indexing="ij")
    k_mag = np.sqrt(sum(k**2 for k in kg)).ravel()
    indices = np.clip(np.digitize(k_mag, k_bins) - 1, 0, n_bins - 1)
    counts = np.bincount(indices, minlength=n_bins)
    present = np.flatnonzero(counts)

    other = [a for a in range(field.ndim) if a not in axes]
    power = power.permute(other + list(axes)).reshape(-1, int(np.prod(shp)))
    dev = power.device
    order = torch.from_numpy(np.argsort(indices, kind="stable")).to(dev)
    offsets = torch.from_numpy(np.concatenate([[0], np.cumsum(counts)])).to(dev)
    sums = torch.segment_reduce(power.index_select(1, order).T, "sum", offsets=offsets, axis=0)
    ps = sums[torch.from_numpy(present).to(dev)].T / torch.as_tensor(
        counts[present], dtype=power.dtype, device=dev)
    final_shape = [field.shape[a] for a in other] + [present.size]
    return ps.reshape(final_shape), torch.as_tensor(k_centers[present], device=dev)
