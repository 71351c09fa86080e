"""Where the port's entry points put what they build: on the card.

An entry point that makes tensors (``CorrelatedFieldMaker.finalize``,
``position_from_numpy``, ``Initializer``, ``random_like``, a likelihood
given numpy data) takes ``device=None`` to mean the CUDA card.  Without a
card that raises; running on the CPU takes ``device="cpu"``.  Functions
that close over numpy constants put them on their input's device
(:class:`Const`).
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["Const", "Float64Tables", "cpu_generator", "resolve"]


def resolve(device=None) -> torch.device:
    """``torch.device(device)``, or the CUDA card when ``device`` is None
    (raises when there is none)."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port's entry points run on the card unless "
            "given device='cpu'"
        )
    return torch.device("cuda")


def cpu_generator(key, default=None) -> torch.Generator:
    """A CPU ``torch.Generator``: ``key`` itself, or one seeded with the int
    ``key`` (``default`` when ``key`` is None).  Draws made on the CPU and
    copied to a device are the same on every device."""
    key = default if key is None else key
    if isinstance(key, torch.Generator):
        if key.device.type != "cpu":
            raise ValueError("these draws are made on the CPU: give an int seed or a CPU generator")
        return key
    if key is None:
        raise ValueError("no seed given")
    return torch.Generator().manual_seed(int(key))


class Const:
    """A constant (numpy or a tensor) held once per device and dtype it is
    asked for: ``Const(a).like(x, dtype)`` is ``a`` on ``x``'s device, in
    ``dtype`` (``a``'s own by default), copied there on first use only."""

    def __init__(self, a):
        self.a = a if isinstance(a, torch.Tensor) else np.asarray(a)
        self.dtype = self.a.dtype if isinstance(a, torch.Tensor) else torch.from_numpy(
            np.empty(0, self.a.dtype)).dtype
        self._copies = {}

    def like(self, x, dtype=None):
        key = (x.device, dtype)
        t = self._copies.get(key)
        if t is None:
            t = self._copies[key] = torch.as_tensor(self.a, device=x.device, dtype=dtype)
        return t


class Float64Tables(torch.nn.Module):
    """A module whose buffers registered by :meth:`register_f64` stay
    float64 whatever dtype ``.to`` (``.float()``, ``.half()``) is given;
    a device given to ``.to`` moves them.  For tables whose rounding to
    the field's dtype would cost more accuracy than the field has."""

    def __init__(self):
        super().__init__()
        self._f64_names = []

    def register_f64(self, name, values):
        """Register ``values`` (numpy or a tensor) as the float64 buffer ``name``."""
        t = values if isinstance(values, torch.Tensor) else torch.from_numpy(
            np.ascontiguousarray(values, dtype=np.float64))
        self.register_buffer(name, t.to(torch.float64))
        self._f64_names.append(name)

    def _apply(self, fn, recurse=True):
        before = {k: self._buffers[k] for k in self._f64_names}
        super()._apply(fn, recurse)
        for k, t in before.items():
            if self._buffers[k].dtype != torch.float64:
                self._buffers[k] = t.to(self._buffers[k].device)
        return self
