"""Carry latent state from the JAX package into the port.

``position_from_numpy`` takes a latent position as numpy arrays (for
instance ``{k: np.asarray(v) for k, v in position.items()}`` of a JAX
position) and returns the port's position dict, after checking each key
and shape against the port model's domain.  The tensors go where the
model's floating buffers are, in their dtype, unless told otherwise; a
model without buffers sends them to the CUDA card.
"""

from __future__ import annotations

import numpy as np
import torch

from . import device as _device

__all__ = ["position_from_numpy"]


def position_from_numpy(model, arrays, device=None, dtype=None):
    """``dict[str, Tensor]`` for ``model`` from ``dict[str, np.ndarray]``."""
    buffers = model.buffers() if isinstance(model, torch.nn.Module) else ()
    ref = next((b for b in buffers if b.is_floating_point()), None)
    if device is None:
        device = ref.device if ref is not None else _device.resolve()
    if dtype is None and ref is not None:
        dtype = ref.dtype
    domain = model.domain
    if set(arrays) != set(domain):
        missing = sorted(set(domain) - set(arrays))
        extra = sorted(set(arrays) - set(domain))
        raise KeyError(f"position keys differ from the domain: missing {missing}, unexpected {extra}")
    out = {}
    for k in sorted(domain):
        a = np.asarray(arrays[k])
        if a.shape != domain[k].shape:
            raise ValueError(f"{k!r}: shape {a.shape}, domain has {domain[k].shape}")
        out[k] = torch.as_tensor(a, device=device, dtype=dtype)
    return out
