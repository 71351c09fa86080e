"""Probing: streaming statistics and the diagonal of a linear map
(counterpart of ``nifty_tpu/probing.py``).

:class:`StatCalculator` is Welford's streaming mean and variance over
trees of tensors.  :func:`probe_diagonal` computes the diagonal of a
linear map exactly (one application a basis vector) or estimates it by
Hutchinson's estimator (:func:`hutchinson_diagonal`) from Rademacher
probes.  The probes are drawn on the CPU from the seed, leaf after leaf
from one stream, and copied to the leaves' device, so a seed gives the
same probes on the card and on the CPU.
"""

from __future__ import annotations

from typing import Callable, Iterable, Optional

import torch

from .device import cpu_generator
from .utils.tree import ravel, tree_map

__all__ = [
    "StatCalculator",
    "hutchinson_diagonal",
    "probe_diagonal",
    "probe_with_posterior_samples",
    "rademacher_probes",
]


class StatCalculator:
    """Streaming (Welford) mean and variance over trees of tensors."""

    def __init__(self):
        self._count = 0
        self._mean = None
        self._m2 = None

    def add(self, value):
        self._count += 1
        if self._mean is None:
            self._mean = tree_map(torch.as_tensor, value)
            self._m2 = tree_map(torch.zeros_like, self._mean)
            return
        delta = tree_map(torch.sub, value, self._mean)
        self._mean = tree_map(lambda m, d: m + d / self._count, self._mean, delta)
        delta2 = tree_map(torch.sub, value, self._mean)
        self._m2 = tree_map(lambda m2, d, d2: m2 + d * d2, self._m2, delta, delta2)

    @property
    def mean(self):
        if self._count == 0:
            raise RuntimeError("no samples added")
        return self._mean

    @property
    def var(self):
        if self._count < 2:
            raise RuntimeError("need at least two samples for a variance")
        return tree_map(lambda m2: m2 / (self._count - 1), self._m2)


def rademacher_probes(proto, key, n_probes: int):
    """``n_probes`` trees shaped like ``proto`` of ±1 entries, in its leaves'
    dtypes and on their devices, drawn on the CPU from ``key`` (an int seed
    or a CPU ``torch.Generator``), leaf after leaf from one stream."""
    g = cpu_generator(key)

    def draw(p):
        r = torch.randint(0, 2, tuple(p.shape), generator=g, dtype=torch.int8)
        return (2 * r - 1).to(p.device, p.dtype)

    for _ in range(n_probes):
        yield tree_map(draw, proto)


def hutchinson_diagonal(op: Callable, probes: Iterable):
    """Hutchinson's estimate of the diagonal of the linear map ``op``: the
    mean of ``probe * op(probe)`` over ``probes`` (trees of ±1 entries)."""
    stat = StatCalculator()
    for probe in probes:
        stat.add(tree_map(torch.mul, probe, op(probe)))
    return stat.mean


def probe_diagonal(op: Callable, proto, key=None, *, n_probes: int = 0):
    """Diagonal of the linear map ``op`` on tensors or trees shaped like
    ``proto``.

    With ``n_probes == 0`` it is computed exactly, one application of
    ``op`` a basis vector on the host (for small operators); otherwise
    estimated by :func:`hutchinson_diagonal` from ``n_probes`` Rademacher
    probes drawn from ``key`` (an int seed or a CPU ``torch.Generator``;
    see :func:`rademacher_probes`)."""
    if n_probes <= 0:
        flat, unravel = ravel(tree_map(torch.zeros_like, proto))
        diag = torch.empty_like(flat)
        for i in range(flat.numel()):
            e = torch.zeros_like(flat)
            e[i] = 1.0
            diag[i] = ravel(op(unravel(e)))[0][i]
        return unravel(diag)
    if key is None:
        raise ValueError("stochastic probing needs a `key`")
    return hutchinson_diagonal(op, rademacher_probes(proto, key, n_probes))


def probe_with_posterior_samples(
    draw_sample: Callable, post_op: Optional[Callable], n_probes: int, key
):
    """Mean and variance (None for one probe) of ``post_op`` of posterior
    samples ``draw_sample(seed)``, the seeds drawn from ``key`` (an int
    seed or a ``torch.Generator``)."""
    g = key if isinstance(key, torch.Generator) else torch.Generator().manual_seed(int(key))
    stat = StatCalculator()
    for _ in range(n_probes):
        seed = int(torch.randint(2**62, (1,), generator=g, device=g.device))
        s = draw_sample(seed)
        stat.add(s if post_op is None else post_op(s))
    return stat.mean, (stat.var if n_probes > 1 else None)
