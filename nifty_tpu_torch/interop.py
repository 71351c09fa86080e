"""Carry latent state from the JAX package into the port.

``position_from_numpy`` takes a latent position as numpy arrays (for
instance ``{k: np.asarray(v) for k, v in position.items()}`` of a JAX
position) and returns the port's position dict, after checking each key
and shape against the port model's domain.  The tensors go where the
model's floating buffers are, in their dtype, unless told otherwise; a
model without buffers sends them to the CUDA card.  ``samples_from_numpy``
does the same for a set of samples: the expansion point and the
residuals, each leaf of these with a leading sample axis.
"""

from __future__ import annotations

import numpy as np
import torch

from . import device as _device

__all__ = ["position_from_numpy", "samples_from_numpy"]


def _placement(model, device, dtype):
    buffers = model.buffers() if isinstance(model, torch.nn.Module) else ()
    ref = next((b for b in buffers if b.is_floating_point()), None)
    if device is None:
        device = ref.device if ref is not None else _device.resolve()
    if dtype is None and ref is not None:
        dtype = ref.dtype
    return device, dtype


def _check_keys(domain, arrays):
    if set(arrays) != set(domain):
        missing = sorted(set(domain) - set(arrays))
        extra = sorted(set(arrays) - set(domain))
        raise KeyError(f"position keys differ from the domain: missing {missing}, unexpected {extra}")


def position_from_numpy(model, arrays, device=None, dtype=None):
    """``dict[str, Tensor]`` for ``model`` from ``dict[str, np.ndarray]``."""
    device, dtype = _placement(model, device, dtype)
    domain = model.domain
    _check_keys(domain, arrays)
    out = {}
    for k in sorted(domain):
        a = np.asarray(arrays[k])
        if a.shape != domain[k].shape:
            raise ValueError(f"{k!r}: shape {a.shape}, domain has {domain[k].shape}")
        out[k] = torch.as_tensor(a, device=device, dtype=dtype)
    return out


def samples_from_numpy(model, pos, residuals, keys=None, device=None, dtype=None):
    """The port's :class:`~nifty_tpu_torch.evi.Samples` for ``model`` from
    numpy: the expansion point ``pos`` (as :func:`position_from_numpy`) and
    the ``residuals``, each leaf ``(n_samples,) + its domain shape`` (for
    instance ``{k: np.asarray(v) for k, v in samples._samples.items()}`` of
    the JAX package's samples); ``keys`` are the port's integer seeds, if
    any."""
    from .evi import Samples

    p = position_from_numpy(model, pos, device=device, dtype=dtype)
    domain = model.domain
    _check_keys(domain, residuals)
    res = {}
    for k in sorted(domain):
        a = np.asarray(residuals[k])
        if a.shape[1:] != domain[k].shape:
            raise ValueError(f"{k!r}: residual shape {a.shape}, domain has {domain[k].shape}")
        res[k] = torch.as_tensor(a, device=p[k].device, dtype=p[k].dtype)
    return Samples(pos=p, samples=res, keys=None if keys is None else list(keys))
