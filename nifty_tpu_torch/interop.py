"""Carry latent state from the JAX package into the port.

``position_from_numpy`` takes a latent position as numpy arrays (for
instance ``{k: np.asarray(v) for k, v in position.items()}`` of a JAX
position) and returns the port's position dict, after checking each key
and shape against the port model's domain.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["position_from_numpy"]


def position_from_numpy(model, arrays, device=None, dtype=None):
    """``dict[str, Tensor]`` for ``model`` from ``dict[str, np.ndarray]``."""
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
