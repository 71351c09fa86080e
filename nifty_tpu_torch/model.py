"""Generative-model core (counterpart of ``nifty_tpu/model.py``).

A model is a :class:`torch.nn.Module` with a ``domain``: a dict mapping
each latent parameter name to its :class:`ShapeWithDtype`.  Its arrays
(mode tables, index tables, data) are buffers, so ``model.to(device,
dtype)`` moves them and casts the floating ones.  Positions are
``dict[str, Tensor]``, so ``torch.func.jvp``/``vjp`` apply to a model
directly.  :class:`Initializer` draws a position from a
:class:`torch.Generator`.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, Optional

import torch

from . import device as _device
from .utils.tree import ShapeWithDtype, random_like

__all__ = ["ChainModel", "Initializer", "Model", "WrappedCall"]


class Initializer:
    """A dict of per-parameter draw functions
    ``f(generator, *, device, dtype) -> Tensor``, or one such function.
    Two dict initializers merge with ``|``.  ``device=None`` draws on the
    CUDA card (raises without one)."""

    def __init__(self, call_or_struct):
        if isinstance(call_or_struct, Initializer):
            call_or_struct = call_or_struct._call_or_struct
        self._call_or_struct = call_or_struct

    def __call__(self, generator, *, device=None, dtype=None):
        device = _device.resolve(device)
        if callable(self._call_or_struct):
            return self._call_or_struct(generator, device=device, dtype=dtype)
        return {
            k: self._call_or_struct[k](generator, device=device, dtype=dtype)
            for k in sorted(self._call_or_struct)
        }

    def __or__(self, other):
        other = other if isinstance(other, Initializer) else Initializer(other)
        return Initializer({**self._call_or_struct, **other._call_or_struct})

    def __repr__(self):
        return f"Initializer({self._call_or_struct!r})"


def _white(domain):
    return {k: partial(random_like, primals=v) for k, v in domain.items()}


class Model(torch.nn.Module):
    """A callable joined with its domain and an initializer (white
    standard-normal draws over the domain unless ``init`` is given)."""

    def __init__(self, call: Optional[Callable] = None, *, domain=None, init=None):
        super().__init__()
        if domain is None:
            raise ValueError("`domain` must be set")
        self._call = call
        self.domain = dict(domain)
        self._init = Initializer(init if init is not None else _white(self.domain))

    @property
    def init(self) -> Initializer:
        return self._init

    def forward(self, *args, **kwargs):
        return self._call(*args, **kwargs)


class WrappedCall(Model):
    """Applies ``call`` to the entry ``x[name]`` of a dict input."""

    def __init__(self, call: Callable, *, name: str, shape=()):
        super().__init__(call, domain={name: ShapeWithDtype(shape)})
        self.name = name

    def forward(self, x):
        return self._call(x[self.name])


class ChainModel(Model):
    """``outer`` after ``inner``; ``outer`` may be a model or any callable
    (``torch.exp``, say)."""

    def __init__(self, outer: Callable, inner: Model):
        super().__init__(domain=inner.domain, init=inner.init)
        self.outer = outer
        self.inner = inner

    def forward(self, x):
        return self.outer(self.inner(x))
