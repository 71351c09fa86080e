"""Eigenvalue spectra of linear maps of a tree to itself (counterpart of
``nifty_tpu/operator_spectrum.py``).

A Hermitian map's leading eigenvalues come from the ELBO's batched,
deflated Lanczos (:func:`~.evidence_lower_bound._eigsh_lanczos`), every
application of the map on its device; the Lanczos batches start from
standard-normal vectors drawn on the CPU in float64 from the seed and
copied to the map's device, so a seed gives the same starts on the card
and on the CPU.  A map that is not Hermitian is materialised column by
column (up to ``dense_cutoff`` degrees of freedom) and its eigenvalues
computed by numpy.
"""

from __future__ import annotations

import itertools
from typing import Any, Callable

import numpy as np
import torch

from .device import cpu_generator
from .evidence_lower_bound import _eigsh_lanczos
from .utils.tree import ravel

__all__ = ["operator_spectrum"]


def operator_spectrum(
    op: Callable,
    domain_proto: Any,
    n_eigenvalues: int,
    *,
    key=None,
    hermitian: bool = True,
    dense_cutoff: int = 512,
    n_batches: int = 10,
    krylov_factor: int = 4,
    verbose: bool = False,
) -> np.ndarray:
    """The ``n_eigenvalues`` leading eigenvalues (largest first, numpy) of
    the linear map ``op`` of trees like ``domain_proto`` (a tensor or a
    dict of tensors) to themselves.

    ``key`` (an int seed, 42 when None, or a CPU ``torch.Generator``)
    draws the Lanczos start vectors.  With ``hermitian=False`` the map is
    materialised densely (at most ``dense_cutoff`` degrees of freedom) and
    its eigenvalues, complex in general, are returned largest modulus
    first."""
    x0, unravel = ravel(domain_proto)
    n = x0.numel()

    def flat_op(v):
        return ravel(op(unravel(v)))[0]

    if not hermitian:
        if n > dense_cutoff:
            raise ValueError(
                f"a non-hermitian spectrum requires dense materialization; "
                f"{n} dofs exceed dense_cutoff={dense_cutoff}"
            )
        eye = torch.eye(n, dtype=x0.dtype, device=x0.device)
        mat = torch.stack([flat_op(eye[:, j]) for j in range(n)], dim=1)
        vals = np.linalg.eigvals(mat.cpu().numpy())
        return vals[np.argsort(-np.abs(vals))][:n_eigenvalues]

    g = cpu_generator(key, default=42)
    starts = (torch.randn(n, generator=g, dtype=torch.float64) for _ in itertools.count())
    vals, _ = _eigsh_lanczos(
        flat_op, n, x0.dtype, int(n_eigenvalues), n, start_vectors=starts, device=x0.device,
        n_batches=n_batches, krylov_factor=krylov_factor, early_stop=False, verbose=verbose,
    )
    return vals
