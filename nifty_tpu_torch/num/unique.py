"""Tolerant uniqueness of sub-arrays, the deduplication behind the
multi-grid stencils (counterpart of ``nifty_tpu/num/unique.py``).

:func:`unique` and :func:`amend_unique` run on the host in numpy and
float64, when a model is built; :func:`amend_unique_` is the static-shape
form on tensors (a fixed-capacity buffer whose free slots hold NaN).
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["amend_unique", "amend_unique_", "unique"]


def _reduce_axes(ndim: int, axis: int):
    axis = int(np.arange(ndim)[axis])
    return axis, tuple(a for a in range(ndim) if a != axis)


def _check_axis(axis):
    if not isinstance(axis, int):
        raise TypeError(f"`axis` must be int; got {type(axis)!r}")


def unique(ar, *, return_inverse: bool = False, axis: int = -1, atol: float = 1e-10,
           rtol: float = 1e-5):
    """Approximately unique sub-arrays of ``ar`` along ``axis``: each pass
    takes the first sub-array not yet matched as a representative and
    absorbs every sub-array within ``atol + rtol |x|`` of it (efficient
    when few are distinct)."""
    _check_axis(axis)
    ar = np.asarray(ar)
    axis, ra = _reduce_axes(ar.ndim, axis)
    n = ar.shape[axis]
    inverse = np.full(n, -1, dtype=int)
    reps = []
    remaining = np.ones(n, dtype=bool)
    while remaining.any():
        rep = np.take(ar, (int(np.flatnonzero(remaining)[0]),), axis=axis)
        reps.append(rep)
        close = np.zeros(n, dtype=bool)
        cand = np.take(ar, np.flatnonzero(remaining), axis=axis)
        close[remaining] = np.all(np.abs(rep - cand) <= (atol + rtol * np.abs(cand)), axis=ra)
        inverse[close] = len(reps) - 1
        remaining &= ~close
    uniqs = np.concatenate(reps, axis=axis)
    return (uniqs, inverse) if return_inverse else uniqs


def amend_unique(ar, el, *, axis: int = -1, atol: float = 1e-10, rtol: float = 1e-5):
    """Append ``el`` to ``ar`` along ``axis`` unless an approximately equal
    sub-array is there already; returns ``(array, index)``."""
    _check_axis(axis)
    ar = np.asarray(ar)
    axis, ra = _reduce_axes(ar.ndim, axis)
    el_e = np.expand_dims(np.asarray(el), axis=axis)
    close = np.all(np.abs(ar - el_e) <= (atol + rtol * np.abs(el_e)), axis=ra)
    hits = np.flatnonzero(close)
    if hits.size:
        return ar, int(hits[0])
    return np.concatenate((ar, el_e), axis=axis), ar.shape[axis]


def amend_unique_(ar, el, *, axis: int = -1, atol: float = 1e-10, rtol: float = 1e-5):
    """The static-shape form on tensors: ``ar`` is a fixed-capacity buffer
    whose free slots hold NaN; ``el`` fills the first free slot unless an
    approximately equal entry is there.  Returns ``(buffer, index)``, the
    index -2³¹ when the buffer is full."""
    _check_axis(axis)
    axis_, ra = _reduce_axes(ar.ndim, axis)
    el_e = el.unsqueeze(axis_)
    close = torch.all(torch.abs(ar - el_e) <= (atol + rtol * torch.abs(el_e)), dim=ra)
    missing = -(1 << 31)
    free_slots = torch.all(torch.isnan(ar), dim=ra)
    pos = torch.arange(ar.shape[axis_], device=ar.device)
    big = ar.shape[axis_]

    def first(mask):
        i = torch.where(mask, pos, big).min()
        return torch.where(i < big, i, missing)

    free, idx = first(free_slots), first(close)
    found = close.any()
    fill = torch.where(found, torch.full_like(el_e, float("nan")), el_e)
    slot = (pos == free).reshape((-1,) + (1,) * (ar.ndim - axis_ - 1))
    ar = torch.where(slot, fill, ar)
    return ar, torch.where(found, idx, free)
