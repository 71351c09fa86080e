"""Interpolation of a regular grid at arbitrary coordinates: the port's
counterpart of ``jax.scipy.ndimage.map_coordinates``.

Orders 0 (nearest, halves rounded away from zero) and 1 (multilinear),
modes ``constant`` and ``wrap``, with JAX's semantics, not scipy's:
``constant`` replaces each out-of-range *corner* by ``cval`` before it is
weighted (so a NaN ``cval`` gives NaN wherever a corner lies outside, even
at weight 0), and ``wrap`` takes ``index % size`` (period ``size``,
scipy's ``grid-wrap``).  Every corner is one gather over all points, so
the result is differentiable in the field and, for order 1, in the
coordinates, and maps under ``torch.func.vmap``.
"""

from __future__ import annotations

import itertools
from typing import Sequence

import torch

__all__ = ["map_coordinates"]


def _nearest(c):
    index = torch.sign(c) * torch.floor(c.abs() + 0.5)  # half away from zero, as lax.round
    return [(index.long(), 1.0)]


def _linear(c):
    lower = torch.floor(c)
    upper_weight = c - lower
    index = lower.long()
    return [(index, 1 - upper_weight), (index + 1, upper_weight)]


def map_coordinates(input, coordinates: Sequence[torch.Tensor], order: int,
                    mode: str = "constant", cval=0.0):
    """``input`` interpolated at ``coordinates`` (one tensor of fractional
    indices per axis of ``input``, all of one shape; a ``(ndim, ...)``
    tensor is read as that sequence)."""
    coordinates = list(coordinates)
    if len(coordinates) != input.ndim:
        raise ValueError(f"coordinates must be a sequence of length input.ndim, but "
                         f"{len(coordinates)} != {input.ndim}")
    if mode not in ("constant", "wrap"):
        raise NotImplementedError(f"mode {mode!r}: only 'constant' and 'wrap' are ported")
    nodes = {0: _nearest, 1: _linear}.get(order)
    if nodes is None:
        raise NotImplementedError("map_coordinates takes order 0 or 1")
    flat = input.reshape(-1)
    strides = [1] * input.ndim
    for d in range(input.ndim - 2, -1, -1):
        strides[d] = strides[d + 1] * input.shape[d + 1]

    per_axis = []
    for c, size in zip(coordinates, input.shape):
        axis = []
        for index, weight in nodes(c):
            if mode == "wrap":
                axis.append((index % size, None, weight))
            else:
                axis.append((index.clamp(0, size - 1), (index >= 0) & (index < size), weight))
        per_axis.append(axis)

    outputs = []
    for items in itertools.product(*per_axis):
        pos = sum(i * s for (i, _, _), s in zip(items, strides))
        val = flat[pos]
        valid = [v for _, v, _ in items if v is not None]
        if valid:
            ok = valid[0]
            for v in valid[1:]:
                ok = ok & v
            val = torch.where(ok, val, torch.as_tensor(cval, dtype=val.dtype, device=val.device))
        weight = items[0][2]
        for _, _, w in items[1:]:
            weight = weight * w
        outputs.append(weight * val)
    result = outputs[0]
    for o in outputs[1:]:
        result = result + o
    if not (input.is_floating_point() or input.is_complex()):
        result = torch.sign(result) * torch.floor(result.abs() + 0.5)
    return result.to(input.dtype)
