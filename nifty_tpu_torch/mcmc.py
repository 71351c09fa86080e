"""Adaptive NUTS sampling with window adaptation (counterpart of
``nifty_tpu/mcmc.py``).

Stan-style warm-up: dual-averaging step-size tuning toward a target
acceptance and a Welford estimate of each parameter's posterior variance
for the diagonal inverse mass matrix, in a fast-slow-fast window
schedule.  The chains run on a leading axis as one batch
(``chain_map="vmap"``: every kernel launches once per batch of chains) or
one after another (``"lmap"``); their per-chain state (step sizes,
dual-averaging state, mass matrices) is ``(B,)`` tensors and forests, and
chain ``c`` draws from its own generator, so both maps give the same
chains.  The JAX package's ``blackjax_nuts`` is not ported (it needs
blackjax).

As in the JAX package, the Welford estimate accumulates from the first
warm-up transition on, not only inside the slow windows, and the
acceptance that drives the step size is clipped to [0, 1].
"""

from __future__ import annotations

import math
import time
from functools import partial
from typing import NamedTuple

import numpy as np
import torch
from torch.utils._pytree import tree_leaves

from . import device as _device
from .evi import Samples, seeds
from .hmc import QP, ChainDraws, generate_nuts_tree
from .hmc_oo import Potential, Ravel, kinetic_energy, make_stepper, map_chains
from .interop import _placement
from .likelihood import Likelihood, LikelihoodWithModel
from .utils.tree import ShapeWithDtype, tree_map

__all__ = ["LogDensity", "get_sample_size_estimate", "nuts_sample"]


class LogDensity(torch.nn.Module):
    """Unnormalized posterior log-density in standardized coordinates:
    ``-lh(x) - ½‖x‖²``, the prior term accumulated in float64."""

    def __init__(self, likelihood: Likelihood):
        super().__init__()
        self.likelihood = likelihood

    def forward(self, x):
        prior = sum(torch.sum((v.conj() * v).real, dtype=torch.float64) for v in tree_leaves(x))
        return -(self.likelihood(x) + 0.5 * prior)


# --- adaptation state --------------------------------------------------------


class _DualAveragingState(NamedTuple):
    log_step: torch.Tensor
    log_step_avg: torch.Tensor
    grad_avg: torch.Tensor
    t: torch.Tensor
    mu: torch.Tensor


def _da_init(step_size):
    """Dual-averaging state of the step sizes ``step_size`` (a float64
    tensor, ``(B,)`` for a batch of chains)."""
    log_step = torch.log(step_size)
    zero = torch.zeros_like(log_step)
    return _DualAveragingState(log_step, zero, zero, zero, math.log(10.0) + log_step)


def _da_update(state: _DualAveragingState, accept_prob, *, target=0.8, gamma=0.05, t0=10.0,
               kappa=0.75):
    t = state.t + 1.0
    g = target - accept_prob
    w = 1.0 / (t + t0)
    grad_avg = (1.0 - w) * state.grad_avg + w * g
    log_step = state.mu - torch.sqrt(t) / gamma * grad_avg
    eta = t ** (-kappa)
    log_step_avg = eta * log_step + (1.0 - eta) * state.log_step_avg
    return _DualAveragingState(log_step, log_step_avg, grad_avg, t, state.mu)


class _WelfordState(NamedTuple):
    count: torch.Tensor
    mean: object
    m2: object


def _welford_init(proto):
    z = tree_map(torch.zeros_like, proto)
    return _WelfordState(torch.tensor(0.0, dtype=torch.float64), z, tree_map(torch.zeros_like, proto))


def _welford_update(state: _WelfordState, x):
    count = state.count + 1.0
    delta = tree_map(torch.sub, x, state.mean)
    mean = tree_map(lambda m, d: m + d / count, state.mean, delta)
    delta2 = tree_map(torch.sub, x, mean)
    m2 = tree_map(lambda m2_, d, d2: m2_ + d * d2, state.m2, delta, delta2)
    return _WelfordState(count, mean, m2)


def _welford_variance(state: _WelfordState, *, regularize=True):
    n = state.count

    def var(m2):
        v = m2 / torch.clamp(n - 1.0, min=1.0)
        if regularize:
            # Stan's shrinkage toward unit variance for short windows
            v = (n / (n + 5.0)) * v + 1e-3 * (5.0 / (n + 5.0))
        return v

    return tree_map(var, state.m2)


def _window_schedule(n_warmup, init_buffer=75, term_buffer=50, first_window=25):
    """Boolean mask marking the last step of each slow (mass-matrix)
    window: Stan's fast/slow/fast expanding schedule."""
    n_warmup = int(n_warmup)
    if n_warmup < 20:
        return np.zeros(max(n_warmup, 0), dtype=bool)
    if init_buffer + term_buffer + first_window > n_warmup:
        scale = n_warmup / (init_buffer + term_buffer + first_window)
        init_buffer = int(init_buffer * scale)
        term_buffer = int(term_buffer * scale)
        first_window = max(1, n_warmup - init_buffer - term_buffer)
    mask = np.zeros(n_warmup, dtype=bool)
    pos = init_buffer
    w = first_window
    while pos + w < n_warmup - term_buffer:
        nxt = pos + w
        if nxt + 2 * w >= n_warmup - term_buffer:
            nxt = n_warmup - term_buffer  # absorb remainder into last window
        mask[nxt - 1] = True
        pos, w = nxt, 2 * w
    if not mask.any():
        mask[n_warmup - term_buffer - 1] = True
    return mask


# --- sampling ----------------------------------------------------------------


class _Transition(NamedTuple):
    position: object
    accept_prob: torch.Tensor
    diverging: torch.Tensor
    depth: torch.Tensor
    leapfrog_steps: int  # batched steps, each evaluating two batched gradients
    seconds: float


def _nuts_transition(potential: Potential, draws: ChainDraws, position, step_size,
                     inverse_mass_matrix, max_tree_depth, max_energy_difference) -> _Transition:
    """One NUTS transition of each chain of the raveled ``position`` ``(B,
    D)`` with its step size ``(B,)`` and inverse mass matrix ``(B, D)``."""
    t0 = time.perf_counter()
    step = make_stepper(potential)
    steps = [0]

    def stepper(*args):
        steps[0] += 1
        return step(*args)

    momentum = draws.momentum(inverse_mass_matrix ** (-0.5))
    tree = generate_nuts_tree(
        QP(position=position, momentum=momentum),
        draws,
        step_size,
        max_tree_depth,
        stepper,
        potential.energy,
        kinetic_energy,
        inverse_mass_matrix,
        max_energy_difference=max_energy_difference,
    )
    n_prop = torch.clamp(torch.exp2(tree.depth.double()) - 1.0, min=1.0)
    accept_prob = torch.clamp(tree.cumulative_acceptance / n_prop, 0.0, 1.0)
    return _Transition(tree.proposal_candidate.position, accept_prob, tree.diverging, tree.depth,
                       steps[0], time.perf_counter() - t0)


def _position_proto(likelihood: Likelihood):
    """The latent domain of a likelihood with a model, as
    :class:`ShapeWithDtype` in the model's dtype, and the model's device."""
    if not isinstance(likelihood, LikelihoodWithModel) or not hasattr(
        likelihood.forward_model, "domain"
    ):
        raise ValueError("position_proto or initial_position required for this likelihood")
    model = likelihood.forward_model
    device, dtype = _placement(model, None, None)
    return {k: ShapeWithDtype(v.shape, dtype) for k, v in model.domain.items()}, device


def _chain_keys(key, n_chains):
    gen = key if isinstance(key, torch.Generator) else torch.Generator().manual_seed(int(key))
    return seeds(gen, n_chains)


def nuts_sample(
    likelihood_or_logdensity,
    key,
    *,
    n_chains: int = 4,
    n_samples: int = 1000,
    n_warmup: int = 1000,
    position_proto=None,
    initial_position=None,
    step_size: float = 0.5,
    max_tree_depth: int = 10,
    target_acceptance: float = 0.8,
    max_energy_difference: float = 1000.0,
    chain_map="vmap",
) -> tuple:
    """Adaptive multi-chain NUTS.

    Takes a :class:`Likelihood` with a model (sampled in standardized
    coordinates, with the standard-normal prior added) or any callable
    log-density of one position, then with ``position_proto`` (a tree of
    tensors, or of :class:`ShapeWithDtype`, drawn on the CUDA card) or
    ``initial_position`` (a forest with a leading chain axis).  ``key`` is
    an integer seed or a :class:`torch.Generator`, from which each chain
    gets its own seed.  Returns ``(samples, info)``: the
    :class:`~nifty_tpu_torch.evi.Samples` with a leading ``n_chains ·
    n_samples`` axis, and the diagnostics of the JAX package (step size,
    inverse mass matrix, acceptance, divergences, tree depths, the samples
    by chain) plus ``leapfrog_steps`` (``(n_chains, n_samples)``, each
    step evaluating the gradient twice) and ``transition_seconds``
    (``(n_chains, n_warmup + n_samples)``, host clock); under ``"vmap"``
    these two are the batch's, shared by its chains.
    """
    device = None
    if isinstance(likelihood_or_logdensity, Likelihood):
        logdensity = LogDensity(likelihood_or_logdensity)
        if position_proto is None and initial_position is None:
            position_proto, device = _position_proto(likelihood_or_logdensity)
    else:
        logdensity = likelihood_or_logdensity
        if position_proto is None and initial_position is None:
            raise ValueError("position_proto or initial_position required for a bare log-density")
    if initial_position is not None:
        device = tree_leaves(initial_position)[0].device
    elif device is None:
        leaf = tree_leaves(position_proto, is_leaf=lambda x: isinstance(x, ShapeWithDtype))[0]
        device = leaf.device if isinstance(leaf, torch.Tensor) else None
    draws = ChainDraws(_chain_keys(key, n_chains), _device.resolve(device))
    if initial_position is None:
        initial_position = draws.normal(position_proto)
    ravel = Ravel(tree_map(lambda x: x[0], initial_position))
    window_mask = _window_schedule(n_warmup)
    potential = Potential(lambda q: -logdensity(q), ravel)
    transition = partial(_nuts_transition, potential, max_tree_depth=max_tree_depth,
                         max_energy_difference=max_energy_difference)

    def run(draws, pos):
        batch = len(draws)
        da = _da_init(torch.full((batch,), float(step_size), dtype=torch.float64, device=draws.device))
        inv_m = torch.ones_like(pos)
        wf = _welford_init(pos)
        w_divs, seconds, outs = [], [], []
        for is_window_end in window_mask:
            out = transition(draws, pos, torch.exp(da.log_step), inv_m)
            pos = out.position
            da = _da_update(da, out.accept_prob, target=target_acceptance)
            wf = _welford_update(wf, pos)
            if is_window_end:
                inv_m = _welford_variance(wf)
                wf = _welford_init(pos)
                # restart the step-size search at the averaged value
                da = _da_init(torch.exp(da.log_step_avg))
            w_divs.append(out.diverging)
            seconds.append(out.seconds)
        eps = torch.exp(da.log_step_avg)
        for _ in range(n_samples):
            out = transition(draws, pos, eps, inv_m)
            pos = out.position
            outs.append(out)
            seconds.append(out.seconds)

        def along(values):
            return torch.stack(values, dim=1)

        def per_batch(values):
            return torch.tensor(values, dtype=torch.float64).expand(batch, -1)

        return dict(
            chain_samples=along([o.position for o in outs]),
            step_size=eps,
            inverse_mass_matrix=inv_m,
            acceptance=along([o.accept_prob for o in outs]).mean(dim=-1),
            divergences=along([o.diverging for o in outs]).sum(dim=-1),
            warmup_divergences=along(w_divs).sum(dim=-1) if w_divs else torch.zeros(batch),
            tree_depths=along([o.depth for o in outs]),
            leapfrog_steps=per_batch([o.leapfrog_steps for o in outs]),
            transition_seconds=per_batch(seconds),
        )

    info = map_chains(chain_map, run, draws, ravel.ravel(initial_position))
    info["chain_samples"] = ravel.unravel(info["chain_samples"])
    info["inverse_mass_matrix"] = ravel.unravel(info["inverse_mass_matrix"])
    flat = tree_map(lambda x: x.reshape((-1,) + tuple(x.shape[2:])), info["chain_samples"])
    return Samples(pos=None, samples=flat), info


def get_sample_size_estimate(samples, axis=0):
    """Crude effective-sample-size estimate from the lag-1 autocorrelation,
    per leaf."""

    def ess(x):
        x = torch.movedim(x, axis, 0)
        n = x.shape[0]
        xc = x - x.mean(dim=0, keepdim=True)
        num = torch.sum(xc[1:] * xc[:-1], dim=0)
        den = torch.sum(xc * xc, dim=0)
        rho1 = torch.where(den > 0, num / den, torch.zeros_like(den))
        rho1 = torch.clamp(rho1, -0.99, 0.99)
        return n * (1.0 - rho1) / (1.0 + rho1)

    return tree_map(ess, samples)
