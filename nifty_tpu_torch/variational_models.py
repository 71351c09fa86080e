"""Parametric variational inference: mean-field and full-covariance
Gaussian posteriors, "ADVI" (counterpart of
``nifty_tpu/variational_models.py``).

A reparametrised Gaussian family q over the raveled latent position (the
dict's keys in sorted order, each leaf C-ordered, as ``ravel_pytree``
lays it out), the stochastic negative ELBO ``E_q[H] − entropy(q)`` over
``n_samples`` draws, and a ``torch.optim`` fit loop (Adam at lr 1e-2 by
default, whose β = 0.9/0.999 and ε = 1e-8 on √v̂ are optax's).  The
Hamiltonians of the draws are one ``torch.func.vmap``, so on the card the
kernels see the draws as their batch.

Randomness: ``loss`` takes the standard-normal draws ``(n_samples, size)``
themselves, or a seed (an int or a :class:`torch.Generator`) to draw
them from; ``fit`` takes a seed or a draw source, a callable from the
step number to the draws.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
from torch.utils._pytree import tree_flatten, tree_unflatten

from .evi import Samples
from .likelihood import Likelihood, StandardHamiltonian

__all__ = ["FullCovarianceVI", "MeanFieldVI"]


def _hamiltonian(likelihood_or_ham):
    if isinstance(likelihood_or_ham, Likelihood):
        return StandardHamiltonian(likelihood_or_ham)
    return likelihood_or_ham


def _sorted(tree):
    if isinstance(tree, dict):
        return {k: _sorted(tree[k]) for k in sorted(tree)}
    return tree


def _ravel(position):
    """``(flat, unravel)``: the leaves laid end to end (dict keys sorted)."""
    leaves, spec = tree_flatten(_sorted(position))
    shapes = [tuple(x.shape) for x in leaves]
    sizes = [math.prod(s) for s in shapes]

    def unravel(flat):
        parts = torch.split(flat, sizes, dim=-1)
        return tree_unflatten([p.reshape(s) for p, s in zip(parts, shapes)], spec)

    return torch.cat([x.reshape(-1) for x in leaves]), unravel


def _adam(params):
    return torch.optim.Adam(params, lr=1e-2)


class _GaussianVI:
    """The shared loop of :class:`MeanFieldVI` and :class:`FullCovarianceVI`:
    ``sample(params, eps)`` maps standard-normal draws to a position."""

    def _setup(self, likelihood, position, n_samples):
        """Set the Hamiltonian and the ravel; return the raveled position."""
        self.hamiltonian = _hamiltonian(likelihood)
        self.n_samples = int(n_samples)
        flat, self._unravel = _ravel(position)
        self._size = flat.numel()
        return flat.detach().clone()

    def normal_draws(self, key, n: int):
        """``n`` standard-normal draws of the raveled position, ``(n, size)``,
        from ``key`` (an int seed or a :class:`torch.Generator`), on the
        parameters' device and in their dtype."""
        ref = self.params["mean"]
        gen = key if isinstance(key, torch.Generator) else (
            torch.Generator(device=ref.device).manual_seed(int(key)))
        return torch.randn((n, self._size), generator=gen, device=ref.device, dtype=ref.dtype)

    def _draws(self, key):
        return key if torch.is_tensor(key) else self.normal_draws(key, self.n_samples)

    def loss(self, params, key):
        """The negative ELBO: the mean Hamiltonian over ``n_samples`` draws
        (``key``: the draws ``(n_samples, size)`` or a seed) minus the
        entropy, one ``torch.func.vmap`` over the draws."""
        ham = torch.func.vmap(lambda e: self.hamiltonian(self.sample(params, e)))(self._draws(key))
        return ham.mean() - self.entropy(params)

    def fit(self, key, *, n_steps=500, optimizer: Optional[Callable] = None, callback=None):
        """``n_steps`` optimizer steps on :meth:`loss`, each at fresh draws:
        from a :class:`torch.Generator` seeded with ``key``, or ``key(i)``
        for a callable.  ``optimizer`` maps the list of parameter tensors to
        a ``torch.optim`` optimizer (Adam at lr 1e-2 by default);
        ``callback(i, params, loss)`` follows each step.  Returns (and keeps)
        the parameters."""
        optimizer = _adam if optimizer is None else optimizer
        params = {k: v.detach().clone().requires_grad_(True) for k, v in self.params.items()}
        opt = optimizer(list(params.values()))
        if callable(key):
            draws = key
        else:
            ref = params["mean"]
            gen = key if isinstance(key, torch.Generator) else (
                torch.Generator(device=ref.device).manual_seed(int(key)))
            draws = lambda i: self.normal_draws(gen, self.n_samples)  # noqa: E731
        for i in range(n_steps):
            opt.zero_grad()
            loss = self.loss(params, draws(i))
            loss.backward()
            opt.step()
            if callback is not None:
                callback(i, params, float(loss.detach()))
        self.params = {k: v.detach() for k, v in params.items()}
        return self.params

    def posterior_samples(self, key, n: int) -> Samples:
        """``n`` draws of q (``key``: a seed or the draws ``(n, size)``)."""
        eps = key if torch.is_tensor(key) else self.normal_draws(key, n)
        with torch.no_grad():
            smpls = torch.func.vmap(lambda e: self.sample(self.params, e))(eps)
        return Samples(pos=None, samples=smpls)

    @property
    def mean(self):
        return self._unravel(self.params["mean"])


class MeanFieldVI(_GaussianVI):
    """Diagonal-covariance Gaussian q(ξ) = N(μ, diag σ²), with
    ``params = {"mean": μ, "log_std": log σ}`` over the raveled position."""

    def __init__(self, likelihood, position, *, n_samples: int = 4, initial_std: float = 0.1):
        flat = self._setup(likelihood, position, n_samples)
        self.params = {"mean": flat, "log_std": torch.full_like(flat, math.log(initial_std))}

    def sample(self, params, eps):
        return self._unravel(params["mean"] + torch.exp(params["log_std"]) * eps)

    def entropy(self, params):
        return torch.sum(params["log_std"])

    @property
    def std(self):
        return self._unravel(torch.exp(self.params["log_std"]))


class FullCovarianceVI(_GaussianVI):
    """Full-covariance Gaussian q(ξ) = N(μ, L Lᵀ), L lower triangular:
    ``params = {"mean", "log_diag", "offdiag"}``, the strict lower triangle
    row by row (``torch.tril_indices``, on the parameters' device)."""

    def __init__(self, likelihood, position, *, n_samples: int = 4, initial_std: float = 0.1):
        flat = self._setup(likelihood, position, n_samples)
        n = self._size
        self._tril = torch.tril_indices(n, n, offset=-1, device=flat.device)
        self.params = {
            "mean": flat,
            "log_diag": torch.full_like(flat, math.log(initial_std)),
            "offdiag": flat.new_zeros(n * (n - 1) // 2),
        }

    def _l_factor(self, params):
        n = self._size
        lower = params["mean"].new_zeros((n, n)).index_put(
            (self._tril[0], self._tril[1]), params["offdiag"])
        return lower + torch.diag(torch.exp(params["log_diag"]))

    def sample(self, params, eps):
        return self._unravel(params["mean"] + self._l_factor(params) @ eps)

    def entropy(self, params):
        return torch.sum(params["log_diag"])

    def covariance(self):
        lower = self._l_factor(self.params)
        return lower @ lower.T
