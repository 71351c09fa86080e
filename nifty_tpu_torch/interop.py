"""Carry latent state from the JAX package into the port.

``position_from_numpy`` takes a latent position as numpy arrays (for
instance ``{k: np.asarray(v) for k, v in position.items()}`` of a JAX
position) and returns the port's position dict, after checking each key
and shape against the port model's domain.  The tensors go where the
model's floating buffers are, in their dtype, unless told otherwise; a
model without buffers sends them to the CUDA card.  It also takes a
domain itself, any tree of :class:`ShapeWithDtype` (a likelihood's
``(mean, std_inv)`` pair, say), and arrays with leading axes before the
domain's shapes (a chain axis, ``batch=(n_chains,)``).  ``samples_from_numpy``
does the same for a set of samples: the expansion point and the
residuals, each leaf of these with a leading sample axis.

A :class:`~.model.VModel`'s domain carries its mapped axis, so its
positions go through ``position_from_numpy`` as any model's; so does a
likelihood's pair domain (``NDVariableCovarianceGaussian(...).domain``,
``(mean, mat)``).  The spherical correlated field's excitations are the
packed real alm (one array); an ICR field's are a list, one array a
refinement level, which takes the JAX package's list (or any sequence)
of arrays.  ``params_from_numpy`` carries the parameters of
:class:`~.variational_models.MeanFieldVI` and ``FullCovarianceVI``
(``{k: np.asarray(v) for k, v in vi.params.items()}`` of the JAX
package's), which share the JAX package's raveled layout.
"""

from __future__ import annotations

import numpy as np
import torch

from . import device as _device
from .utils.tree import ShapeWithDtype, tree_map

__all__ = ["params_from_numpy", "position_from_numpy", "samples_from_numpy"]


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


def position_from_numpy(model, arrays, device=None, dtype=None, batch=(), sharding=None):
    """The position for ``model`` (a model, whose ``domain`` is a dict of
    :class:`ShapeWithDtype`, or a domain itself: any tree of them) from the
    same tree of numpy arrays, each of shape ``batch + `` its domain leaf's
    shape; a dict comes back with its keys sorted.  A domain leaf's dtype,
    where it names one, wins over ``dtype``.  With ``sharding`` (a dict of
    :class:`~.parallel.NamedSharding`, ``model.position_sharding()`` of a
    field-sharded model) each leaf is this rank's shard of the array."""
    device, dtype = _placement(model, device, dtype)
    domain = model.domain if isinstance(model, torch.nn.Module) else model
    batch = tuple(batch)

    def convert(shape, a, where):
        a = np.asarray(a)
        if a.shape != batch + tuple(shape.shape):
            raise ValueError(f"{where}: shape {a.shape}, domain has {batch} + {shape.shape}")
        return torch.as_tensor(a, device=device, dtype=shape.dtype or dtype)

    def convert_tree(shapes, a, where):
        if isinstance(shapes, (list, tuple)):  # per-level leaves: any sequence of arrays
            if not isinstance(a, (list, tuple)) or len(a) != len(shapes):
                raise ValueError(f"{where}: {len(shapes)} arrays expected")
            return type(shapes)(convert_tree(s, x, f"{where}[{i}]")
                                for i, (s, x) in enumerate(zip(shapes, a)))
        return tree_map(lambda s, x: convert(s, x, where), shapes, a,
                        is_leaf=lambda x: isinstance(x, ShapeWithDtype))

    if sharding is not None:
        _check_keys(domain, sharding)
        arrays = {k: sharding[k].shard(torch.from_numpy(np.asarray(arrays[k]))).numpy()
                  for k in arrays}
        domain = {k: ShapeWithDtype(tuple(arrays[k].shape[len(batch):]), v.dtype)
                  for k, v in domain.items()}
    if isinstance(domain, dict):
        _check_keys(domain, arrays)
        return {k: convert_tree(domain[k], arrays[k], repr(k)) for k in sorted(domain)}
    return convert_tree(domain, arrays, "leaf")


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


def params_from_numpy(vi, arrays):
    """The variational parameters of ``vi`` (a ``MeanFieldVI`` or
    ``FullCovarianceVI``) from numpy arrays of the same keys and shapes, on
    the device and in the dtype of its own; returns the dict (set it as
    ``vi.params``)."""
    _check_keys(vi.params, arrays)
    out = {}
    for k, ref in vi.params.items():
        a = np.asarray(arrays[k])
        if a.shape != tuple(ref.shape):
            raise ValueError(f"{k!r}: shape {a.shape}, the parameters have {tuple(ref.shape)}")
        out[k] = torch.as_tensor(a, device=ref.device, dtype=ref.dtype)
    return out
