"""Samples to and from files: pickle and HDF5 (counterpart of
``nifty_tpu/io.py``).

Everything pickled goes through :func:`to_cpu` first (tensors to the CPU,
a ``torch.Generator`` to its state), and everything loaded through
:func:`to_device`, so a file written on the card loads on a machine
without one.  ``optimize_kl``'s checkpoints (``odir/last.pkl``) are
written the same way.  h5py is imported only by :func:`samples_to_hdf5`.
"""

from __future__ import annotations

import hashlib
import os
import pickle
from typing import Callable, Mapping, Optional

import numpy as np
import torch
from torch.utils import _pytree as pytree

from . import device as _device
from .evi import Samples

__all__ = ["load_samples", "samples_to_hdf5", "save_samples", "to_cpu", "to_device"]


class GeneratorState:
    """A ``torch.Generator`` as its device type and state, to pickle."""

    def __init__(self, generator: torch.Generator):
        self.device_type = generator.device.type
        self.state = generator.get_state()

    def restore(self, device: torch.device) -> torch.Generator:
        """The generator on ``device``: the same stream on a device of its
        own type; on another, a generator seeded from the state's bytes
        (reproducible, but another stream)."""
        g = torch.Generator(device=device)
        if device.type == self.device_type:
            g.set_state(self.state)
        else:
            digest = hashlib.blake2b(self.state.numpy().tobytes(), digest_size=8).digest()
            g.manual_seed(int.from_bytes(digest, "little") >> 1)
        return g


def _is_node(x):
    return isinstance(x, (Samples, torch.Generator, GeneratorState))


def to_cpu(obj):
    """``obj`` (a tree, possibly holding :class:`~.evi.Samples` and
    generators) with every tensor on the CPU and every generator as a
    :class:`GeneratorState`."""

    def move(x):
        if isinstance(x, Samples):
            return Samples(pos=to_cpu(x.pos), samples=to_cpu(x._samples), keys=to_cpu(x.keys))
        if isinstance(x, torch.Tensor):
            return x.detach().cpu()
        if isinstance(x, torch.Generator):
            return GeneratorState(x)
        return x

    return pytree.tree_map(move, obj, is_leaf=_is_node)


def to_device(obj, device=None):
    """The inverse of :func:`to_cpu`: tensors and generators on ``device``
    (the CUDA card by default)."""
    device = _device.resolve(device)

    def move(x):
        if isinstance(x, Samples):
            return Samples(pos=to_device(x.pos, device), samples=to_device(x._samples, device),
                           keys=to_device(x.keys, device))
        if isinstance(x, torch.Tensor):
            return x.to(device)
        if isinstance(x, GeneratorState):
            return x.restore(device)
        return x

    return pytree.tree_map(move, obj, is_leaf=_is_node)


def dump(obj, path: str):
    """Pickle :func:`to_cpu` of ``obj`` to ``path`` through a temporary file
    moved into place."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        pickle.dump(to_cpu(obj), f)
    os.replace(tmp, path)


def load(path: str, device=None):
    """:func:`to_device` of what :func:`dump` wrote to ``path`` (a file this
    program wrote: unpickling runs code)."""
    with open(path, "rb") as f:
        return to_device(pickle.load(f), device)


def save_samples(samples: Samples, path: str):
    """Pickle ``samples``, their tensors on the CPU, atomically."""
    dump(samples, path)


def load_samples(path: str, device=None) -> Samples:
    """The samples of a file of :func:`save_samples`, or of an
    ``optimize_kl`` checkpoint (``(samples, state)``), on ``device`` (the
    CUDA card by default)."""
    out = load(path, device)
    if isinstance(out, tuple) and len(out) == 2 and isinstance(out[0], Samples):
        out = out[0]
    if not isinstance(out, Samples):
        raise TypeError(f"{path} does not hold a Samples object")
    return out


def _to_group(group, name, tree):
    leaves, spec = pytree.tree_flatten(tree)
    sub = group.create_group(name)
    for i, leaf in enumerate(leaves):
        sub.create_dataset(str(i), data=np.asarray(leaf))
    sub.attrs["treedef"] = str(spec)


def samples_to_hdf5(
    samples: Samples,
    path: str,
    *,
    operators: Optional[Mapping[str, Callable]] = None,
    overwrite: bool = False,
):
    """Export samples, and the outputs of ``operators`` (name -> a callable
    of one sample) over them, to HDF5: ``/<name>/{samples,mean,std}``, one
    dataset a leaf (the latent samples under ``latent``)."""
    import h5py

    if os.path.exists(path) and not overwrite:
        raise FileExistsError(f"{path} exists (pass overwrite=True)")
    operators = {} if operators is None else dict(operators)
    operators.setdefault("latent", lambda x: x)
    with h5py.File(path, "w") as f, torch.no_grad():
        f.attrs["n_samples"] = len(samples)
        for name, op in operators.items():
            outs = [to_cpu(op(s)) for s in samples]
            stacked = pytree.tree_map(lambda *a: np.stack([x.numpy() for x in a]), *outs)
            grp = f.create_group(name)
            _to_group(grp, "samples", stacked)
            _to_group(grp, "mean", pytree.tree_map(lambda a: a.mean(axis=0), stacked))
            _to_group(grp, "std", pytree.tree_map(
                lambda a: a.std(axis=0, ddof=1) if a.shape[0] > 1 else np.zeros_like(a[0]), stacked))
