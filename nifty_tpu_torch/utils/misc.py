"""Small shared helpers (counterpart of ``nifty_tpu/utils/misc.py``)."""

from typing import Callable

import numpy as np
import torch

from .. import device as _device
from ..num.stats_distributions import interp
from .tree import tree_map

__all__ = [
    "conditional_call",
    "conditional_raise",
    "hvp",
    "interpolate",
    "wrap",
    "wrap_left",
]


def wrap(call: Callable, name) -> Callable:
    """Adapt ``call`` to act on ``x[name]`` of a dict-like input."""

    def named_call(x, *args, **kwargs):
        return call(x[name], *args, **kwargs)

    return named_call


def wrap_left(call: Callable, name) -> Callable:
    """Adapt ``call`` so that its output is wrapped in a dict under ``name``."""

    def named_call(*args, **kwargs):
        return {name: call(*args, **kwargs)}

    return named_call


def hvp(f, primals, tangents):
    """Hessian-vector product of the scalar function ``f``: forward over
    reverse, ``primals`` and ``tangents`` tuples of its arguments, in the
    dtypes of the first argument's leaves (forward over reverse through a
    float32 model that sums in float64, the correlated field's amplitude,
    returns float64 tangents for some leaves)."""
    out = torch.func.jvp(torch.func.grad(f), primals, tangents)[1]
    return tree_map(lambda h, x: h.to(x.dtype), out, primals[0])


def interpolate(xmin=-7.0, xmax=7.0, *, num: int = 1400) -> Callable:
    """Decorator: replace an expensive pointwise function by the linear
    interpolant of its values at ``num`` points from ``xmin`` to
    ``xmax`` (``jnp.interp``'s: clamped outside).  The function is
    tabulated once on a float64 CPU tensor; the table is copied to an
    input's device on first use there, and the interpolant evaluated in
    float64 and returned in the input's dtype."""

    def decorator(f):
        xs = np.linspace(xmin, xmax, num)
        ys = torch.as_tensor(f(torch.from_numpy(xs)), dtype=torch.float64)
        tables = _device.Const(xs), _device.Const(ys)

        def interpolated(x):
            xp, fp = (t.like(x, torch.float64) for t in tables)
            return interp(x.to(torch.float64), xp, fp).to(x.dtype)

        return interpolated

    return decorator


def conditional_raise(condition, exception):
    """Raise ``exception`` when ``condition`` holds (read on the host)."""
    if bool(condition):
        raise exception


def conditional_call(condition, call, *args):
    """``call(*args)`` when ``condition`` holds (read on the host)."""
    if bool(condition):
        call(*args)
