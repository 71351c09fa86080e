"""Harmonic transforms on regular grids (counterpart of ``nifty_tpu/ops/fft.py``).

The Hartley transform H(x) = Re F(x) - Im F(x), the real self-inverse
workhorse of the correlated field (H(H(x)) = N x).  A real f32 transform
over the trailing two axes, both in the domain of the hand-written kernel
pair (:mod:`.cuda_fft`: multiples of 256), goes through
:class:`~.cuda_fft.Hartley2d`, which runs K3 + K4 on the card (one launch
pair per slice of a leading batch) and their plain versions on the CPU.
Everything else runs the plain version: ``rfftn`` plus the hermitian
extension of the half spectrum, as the reference's generic branch does.
The choice is made by shape, axes and dtype alone.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from .cuda_fft import Hartley2d, cuda_hartley_supported

__all__ = ["hartley", "hartley_plain"]


def _hermitian_extend(ft_half, shape, axes):
    """Reconstruct the full FFT array from the ``rfftn`` half spectrum:
    F[k_1, ..., k_d] = conj(F[-k_1, ..., -k_d])."""
    last = axes[-1]
    n = shape[last]
    n_half = ft_half.shape[last]
    if n_half == n:
        return ft_half
    dev = ft_half.device
    missing = ft_half.index_select(last, torch.arange(1, n - n_half + 1, device=dev))
    missing = torch.conj_physical(missing.flip(last))
    for ax in axes[:-1]:
        m = missing.shape[ax]
        missing = missing.index_select(ax, (-torch.arange(m, device=dev)) % m)
    return torch.cat([ft_half, missing], dim=last)


def hartley_plain(x, axes: Optional[Sequence[int]] = None):
    """Hartley transform over ``axes`` through ``torch.fft``."""
    axes = tuple(range(x.ndim)) if axes is None else tuple(a % x.ndim for a in axes)
    if x.is_complex():
        ft = torch.fft.fftn(x, dim=axes)
        return ft.real - ft.imag
    ft = _hermitian_extend(torch.fft.rfftn(x, dim=axes), x.shape, axes)
    return ft.real - ft.imag


def hartley(x, axes: Optional[Sequence[int]] = None):
    """Hartley transform over ``axes`` (all axes by default)."""
    axes = tuple(range(x.ndim)) if axes is None else tuple(a % x.ndim for a in axes)
    if (
        not x.is_complex()
        and sorted(axes) == [x.ndim - 2, x.ndim - 1]
        and cuda_hartley_supported(x.shape[-2:], x.dtype)
    ):
        return Hartley2d.apply(x)
    return hartley_plain(x, axes)
