"""Lanczos tridiagonalisation and stochastic log-determinants (counterpart
of ``nifty_tpu/num/lanczos.py``).

The Krylov recurrence runs on the device with no host read: each new
basis vector is reorthogonalised against the whole basis by two dense
products (``V @ w``, then ``Vᵀ @ coeff``), as the JAX package does; a
breakdown (β ≈ 0) pads the basis with zero vectors instead of ending, so
the shapes do not depend on the data.  The basis is a list of vectors
stacked when needed, so the recurrence also runs under
``torch.func.vmap`` (:func:`stochastic_lq_logdet` maps it over its probes).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

__all__ = [
    "lanczos_tridiag",
    "stochastic_logdet_from_lanczos",
    "stochastic_lq_logdet",
]


def lanczos_tridiag(mat: Callable, v, *, order: int, tol: float = 1e-12):
    """Lanczos decomposition ``mat ≈ Vᵀ T V`` with full reorthogonalisation:
    ``(T, V)``, the ``(order, order)`` tridiagonal matrix and the ``(order,
    n)`` Krylov basis started from the flat vector ``v`` (not necessarily
    normalised); ``mat`` is a symmetric matrix-vector product on flat
    vectors."""
    if order < 1:
        raise ValueError("order must be >= 1")
    if v.ndim != 1:
        raise ValueError("lanczos_tridiag operates on flat vectors")

    def next_vector(w, beta):
        return torch.where(beta > tol, 1.0 / beta, 0.0) * w

    q = v / torch.linalg.vector_norm(v)
    basis = [q]
    w = mat(q)
    alphas = [torch.dot(w, q)]
    betas = []
    for i in range(1, order):
        if i > 1:
            w = mat(q) - betas[-1] * basis[-2]
            alphas.append(torch.dot(w, q))
        w = w - alphas[-1] * q
        if i > 1:  # the second vector is orthogonal to the first by construction
            V = torch.stack(basis)
            w = w - V.T @ (V @ w)
        betas.append(torch.linalg.vector_norm(w))
        q = next_vector(w, betas[-1])
        basis.append(q)
    if order > 1:  # the last diagonal entry (no new basis vector)
        w = mat(q) - betas[-1] * basis[-2]
        alphas.append(torch.dot(w, q))
    T = torch.diag(torch.stack(alphas))
    if betas:
        b = torch.stack(betas)
        T = T + torch.diag(b, 1) + torch.diag(b, -1)
    return T, torch.stack(basis)


def stochastic_logdet_from_lanczos(tridiag_stack, matrix_shape0: int):
    """Stochastic-Lanczos-quadrature log-determinant from a stack of
    tridiagonal matrices, one a probe: n · mean over probes of
    Σ_i (e₁ᵀ u_i)² log λ_i, (λ, u) the eigensystem of each."""
    eig_vals, eig_vecs = torch.linalg.eigh(tridiag_stack)
    log_eig = torch.log(torch.clamp_min(eig_vals, torch.finfo(eig_vals.dtype).tiny))
    w1 = eig_vecs[..., 0, :]  # the start vector's weight in each Ritz vector
    per_probe = torch.sum(w1 * w1 * log_eig, dim=-1)
    return matrix_shape0 * torch.mean(per_probe)


def stochastic_lq_logdet(
    mat,
    order: int,
    n_samples: int,
    key: Optional[torch.Generator] = None,
    *,
    shape0: Optional[int] = None,
    dtype=None,
    probes=None,
):
    """Stochastic Lanczos quadrature estimate of ``log|det(mat)|``: ``mat``
    a dense matrix or a flat matrix-vector product (then ``shape0`` is its
    size).  The ``n_samples`` Rademacher probes come from ``key`` (on its
    device, in ``dtype``, float64 by default) or are handed in as
    ``probes`` (``(n_samples, n)``); the Lanczos runs are one batch under
    ``torch.func.vmap``."""
    if callable(mat):
        if shape0 is None:
            raise ValueError("shape0 required for a callable `mat`")
        matvec, n = mat, int(shape0)
    else:
        n = mat.shape[0]
        matvec = lambda x: mat @ x  # noqa: E731
    if probes is None:
        dtype = torch.float64 if dtype is None else dtype
        bits = torch.randint(0, 2, (n_samples, n), generator=key, device=key.device)
        probes = (2 * bits - 1).to(dtype)
    else:
        probes = torch.as_tensor(probes)
    tridiags = torch.func.vmap(lambda v: lanczos_tridiag(matvec, v, order=order)[0])(probes)
    return stochastic_logdet_from_lanczos(tridiags, n)
