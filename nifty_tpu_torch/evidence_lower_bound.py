"""The evidence lower bound (ELBO) of a metric-Gaussian posterior
approximation from the spectrum of its metric (counterpart of
``nifty_tpu/evidence_lower_bound.py``).

The ELBO is the sample-averaged Hamiltonian plus the entropy of the
approximation, whose only hard part is ``tr log M⁻¹`` of the Hamiltonian
metric ``M = M_lh + 1``.  Only eigenvalues above one contribute, at most
``min(n_data, n_params)`` of them (the likelihood-informed directions); the
rest are exactly one.  They are found by a batched, deflated Lanczos on the
device: each batch runs :func:`~.num.lanczos.lanczos_tridiag` on ``P M P``,
P = 1 − V Vᵀ the projection off the eigenvectors found so far, so every
metric apply (and with it K1-K4) runs on the card; the small tridiagonal
eigenproblem is ``torch.linalg.eigh`` and the basis is re-orthonormalised
by a QR after each batch.  The host reads the Ritz values of each batch to
decide which to keep and whether to go on.
"""

from __future__ import annotations

import math
import os
from typing import Optional

import numpy as np
import torch
from torch.utils._pytree import tree_leaves

from .evi import Samples
from .likelihood import Likelihood, StandardHamiltonian
from .logger import logger
from .num.lanczos import lanczos_tridiag
from .utils.tree import ShapeWithDtype, ravel, vmap

__all__ = ["estimate_evidence_lower_bound"]


def _ravel_metric(metric, position):
    """``(matvec, size, dtype, device)``: ``metric(position, ·)`` on flat
    vectors, the leaves of a dict in sorted key order (as the JAX package's
    ``ravel_pytree``)."""
    flat, unravel = ravel(position)

    def met(x):
        return ravel(metric(position, unravel(x)))[0]

    return met, flat.numel(), flat.dtype, flat.device


def _eigsh_lanczos(
    met,
    metric_size,
    dtype,
    n_eigenvalues,
    tot_dofs,
    *,
    key: Optional[torch.Generator] = None,
    start_vectors=None,
    device=None,
    min_lh_eval=1e-3,
    n_batches=10,
    krylov_factor=4,
    early_stop=True,
    verbose=True,
    resume_eigenvalues=None,
    resume_eigenvectors=None,
):
    """The ``n_eigenvalues`` largest eigenpairs of the metric by batched,
    deflated Lanczos with full reorthogonalisation: ``(eigenvalues, largest
    first, as float64 numpy; eigenvectors, a (k, metric_size) tensor on the
    device)``.  Each batch starts from a standard-normal vector drawn from
    ``key`` or the next row of ``start_vectors``."""
    if n_eigenvalues > tot_dofs:
        raise ValueError("number of requested eigenvalues exceeds the relevant degrees of freedom")
    batch_take = max(1, -(-n_eigenvalues // n_batches))
    order = int(min(metric_size, krylov_factor * batch_take + 10))
    starts = iter(()) if start_vectors is None else iter(start_vectors)

    eigenvalues = np.zeros((0,), dtype=np.float64)
    basis = torch.zeros((n_eigenvalues, metric_size), dtype=dtype, device=device)
    n_found = 0
    if resume_eigenvectors is not None:
        ev = torch.as_tensor(resume_eigenvectors)
        if ev.ndim != 2 or ev.shape[1] != metric_size:
            raise ValueError("resume_eigenvectors must be (k, metric_size)")
        el = np.asarray(resume_eigenvalues, dtype=np.float64)
        order_idx = np.argsort(-el)[:n_eigenvalues]
        eigenvalues = el[order_idx]
        n_found = eigenvalues.size
        basis[:n_found] = ev[torch.from_numpy(order_idx)].to(basis)
        if verbose:
            logger.info(f"ELBO: resuming with {n_found} precomputed eigenvalues")

    while n_found < n_eigenvalues:
        if early_stop and n_found > 0 and abs(1.0 - float(np.min(eigenvalues))) < min_lh_eval:
            if verbose:
                logger.info(f"ELBO: early stop at {n_found} eigenvalues (min λ ≈ 1)")
            break
        if start_vectors is None:
            v0 = torch.randn(metric_size, generator=key, device=device, dtype=dtype)
        else:
            v0 = torch.as_tensor(next(starts), device=device, dtype=dtype)

        def deflate(x):
            return x - basis.T @ (basis @ x)

        tridiag, vecs = lanczos_tridiag(lambda x: deflate(met(deflate(x))), deflate(v0), order=order)
        tvals, tvecs = torch.linalg.eigh(tridiag)
        tvals, tvecs = tvals.flip(0), tvecs.flip(1)  # Ritz pairs, largest first
        take = int(min(batch_take, n_eigenvalues - n_found))
        ritz_vals = tvals[:take].double().cpu().numpy()
        # the deflated operator is 0 on the found subspace: keep only values
        # clearly above it (the metric's eigenvalues are >= 1)
        keep = ritz_vals > 0.5
        if not keep.any():
            if verbose:
                logger.info("ELBO: a Lanczos batch returned no new eigenvalues; stop")
            break
        ritz_vecs = (vecs.T @ tvecs[:, :take]).T[torch.from_numpy(keep).to(tvecs.device)]
        k = int(keep.sum())
        basis[n_found : n_found + k] = ritz_vecs
        eigenvalues = np.concatenate([eigenvalues, ritz_vals[keep]])
        n_found += k
        if verbose:
            logger.info(
                f"ELBO: {n_found}/{n_eigenvalues} eigenvalues, current min λ = {np.min(eigenvalues):.6f}"
            )
        q, _ = torch.linalg.qr(basis[:n_found].T)
        basis[:n_found] = q.T

    order_idx = np.argsort(-eigenvalues)
    return eigenvalues[order_idx], basis[:n_found][torch.from_numpy(order_idx).to(basis.device)]


def estimate_evidence_lower_bound(
    likelihood: Likelihood,
    samples: Samples,
    n_eigenvalues: int,
    *,
    key: Optional[torch.Generator] = None,
    start_vectors=None,
    min_lh_eval: float = 1e-3,
    n_batches: int = 10,
    compute_all: bool = False,
    verbose: bool = True,
    output_directory: Optional[str] = None,
    save_eigensystem_prefix: str = "metric",
    resume_eigenvalues=None,
    resume_eigenvectors=None,
):
    """The ELBO of the metric-Gaussian approximation that ``samples``
    (around ``samples.pos``) represent: ``(elbo of each sample as float64
    numpy, stats)``, the stats ``elbo_mean``, ``elbo_up``, ``elbo_lw`` and
    ``lower_error`` (the truncation: the unresolved eigenvalues bounded by
    the smallest found).

    The Lanczos batches start from standard-normal vectors drawn from
    ``key`` (a ``torch.Generator`` on the position's device; seed 42 if
    none is given), or from the rows of ``start_vectors``.  With
    ``output_directory`` the eigensystem is saved to
    ``<prefix>_eigsys.npz`` there, and read back on the next call unless
    ``resume_eigenvalues``/``resume_eigenvectors`` are given."""
    if not isinstance(samples, Samples):
        raise TypeError("`samples` must be a Samples instance")
    if not isinstance(likelihood, Likelihood):
        raise TypeError("`likelihood` must be a Likelihood instance")
    hamiltonian = StandardHamiltonian(likelihood)
    met, metric_size, dtype, device = _ravel_metric(hamiltonian.metric, samples.pos)
    if key is None and start_vectors is None:
        key = torch.Generator(device=device).manual_seed(42)
    shapes = tree_leaves(likelihood.lsm_tangents_shape, is_leaf=lambda x: isinstance(x, ShapeWithDtype))
    n_data_points = sum(math.prod(s.shape) for s in shapes)
    n_relevant_dofs = int(min(n_data_points, metric_size))
    if compute_all:
        n_eigenvalues = n_relevant_dofs

    fn = None
    if output_directory is not None:
        fn = os.path.join(output_directory, f"{save_eigensystem_prefix}_eigsys.npz")
    if resume_eigenvectors is None and fn is not None and os.path.isfile(fn):
        with np.load(fn) as f:
            resume_eigenvalues, resume_eigenvectors = f["eigenvalues"], f["eigenvectors"]
        if verbose:
            logger.info(f"ELBO: resuming eigensystem from {fn}")

    eigenvalues, eigenvectors = _eigsh_lanczos(
        met, metric_size, dtype, n_eigenvalues, tot_dofs=n_relevant_dofs, key=key,
        start_vectors=start_vectors, device=device, min_lh_eval=min_lh_eval,
        n_batches=n_batches, early_stop=not compute_all, verbose=verbose,
        resume_eigenvalues=resume_eigenvalues, resume_eigenvectors=resume_eigenvectors,
    )
    if fn is not None:
        os.makedirs(output_directory, exist_ok=True)
        np.savez(fn, eigenvalues=eigenvalues, eigenvectors=eigenvectors.cpu().numpy())
    if verbose:
        logger.info(
            f"ELBO: computed {eigenvalues.size} largest eigenvalues of {n_relevant_dofs} "
            f"relevant dofs (metric size {metric_size}); remaining eigenvalues are 1"
        )

    log_eigenvalues = np.log(np.maximum(eigenvalues, np.finfo(np.float64).tiny))
    tr_log_lat_cov = -0.5 * np.sum(log_eigenvalues)
    tr_log_lat_cov_lower = (
        0.5 * (n_relevant_dofs - log_eigenvalues.size) * np.min(log_eigenvalues)
        if log_eigenvalues.size
        else 0.0
    )
    posterior_contribution = tr_log_lat_cov + 0.5 * metric_size
    energies = vmap(hamiltonian.energy)(samples.samples).double().cpu().numpy()
    elbo_samples = posterior_contribution - energies

    stats = {"lower_error": tr_log_lat_cov_lower}
    elbo_mean = float(np.mean(elbo_samples))
    elbo_std = float(np.std(elbo_samples, ddof=1)) if elbo_samples.size > 1 else 0.0
    stats["elbo_mean"] = elbo_mean
    stats["elbo_up"] = elbo_mean + elbo_std
    stats["elbo_lw"] = elbo_mean - elbo_std - stats["lower_error"]
    if verbose:
        logger.info(
            f"ELBO mean: {elbo_mean:.4e} (lower: {stats['elbo_lw']:.4e}, "
            f"upper: {stats['elbo_up']:.4e})"
        )
    return elbo_samples, stats
