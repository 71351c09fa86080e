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

__all__ = ["Const", "resolve"]


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
