"""Likelihood core: energies with Fisher metrics and their square roots
(counterpart of ``nifty_tpu/likelihood.py``).

A :class:`Likelihood` is an energy (negative log-likelihood) with

* ``transformation``: the map into coordinates where the metric is
  Euclidean;
* ``left_sqrt_metric`` (LSM): the pull-back (vjp) of ``transformation``;
* ``right_sqrt_metric`` (RSM): its push-forward (jvp), the LSM's transpose;
* ``metric`` = LSM ∘ RSM, the Fisher metric.

For a likelihood composed with a forward model f, the metric is
Jᶠᵀ M Jᶠ: one ``torch.func.jvp`` pushes the tangent forward and one
``torch.func.vjp`` pulls the result back (the JAX package uses
``jax.linearize`` plus its ``linear_transpose``).  This apply is the hot
loop of variational inference.

Positions are dicts of tensors.  :meth:`Likelihood.freeze` fixes some of
their keys (point estimates): the :class:`LikelihoodPartial` it returns
takes and returns dicts of the other keys only.
"""

from __future__ import annotations

from typing import Callable

import torch

from .utils.tree import ShapeWithDtype, tree_map, vdot

__all__ = ["Likelihood", "LikelihoodPartial", "LikelihoodWithModel", "StandardHamiltonian"]


class Likelihood(torch.nn.Module):
    """Negative log-likelihood with metric algebra.  Subclasses implement
    ``energy`` and, for the metric, ``transformation`` or the metric
    methods themselves.  Data are buffers, so ``.to`` moves them.

    ``lsm_tangents_shape`` (also ``left_sqrt_metric_tangents_shape``) is the
    shape of the data-space tangents that the left square root of the
    metric takes, as a :class:`ShapeWithDtype` without a dtype: a sampler
    draws them in the working dtype of the position."""

    def forward(self, primals):
        return self.energy(primals)

    @property
    def lsm_tangents_shape(self):
        return ShapeWithDtype(tuple(self.data.shape))

    @property
    def left_sqrt_metric_tangents_shape(self):
        return self.lsm_tangents_shape

    def freeze(self, *, primals, point_estimates):
        """``(likelihood, liquid primals)`` with the keys ``point_estimates``
        of ``primals`` fixed at their values; the likelihood itself and
        ``primals`` when there are none."""
        if not point_estimates:
            return self, primals
        lp = LikelihoodPartial(self, primals=primals, point_estimates=point_estimates)
        return lp, lp.liquid(primals)

    def energy(self, primals):
        raise NotImplementedError("`energy` is not implemented")

    def normalized_residual(self, primals):
        raise NotImplementedError("`normalized_residual` is not implemented")

    def transformation(self, primals):
        raise NotImplementedError("`transformation` is not implemented")

    def metric(self, primals, tangents):
        """Fisher metric applied to ``tangents`` at ``primals`` (LSM ∘ RSM)."""
        return self.left_sqrt_metric(primals, self.right_sqrt_metric(primals, tangents))

    def left_sqrt_metric(self, primals, tangents):
        """Pull-back of data-space tangents: the vjp of ``transformation``."""
        _, vjp_fn = torch.func.vjp(self.transformation, primals)
        return vjp_fn(tangents)[0]

    def right_sqrt_metric(self, primals, tangents):
        """Push-forward of parameter tangents: the jvp of ``transformation``."""
        return torch.func.jvp(self.transformation, (primals,), (tangents,))[1]

    def amend(self, f: Callable) -> "LikelihoodWithModel":
        """Compose a forward model to the right of the likelihood."""
        return LikelihoodWithModel(self, f)


class LikelihoodWithModel(Likelihood):
    """A likelihood composed with a forward model ``f`` (lh ∘ f)."""

    def __init__(self, likelihood: Likelihood, f: Callable):
        super().__init__()
        if not callable(f):
            raise TypeError(f"forward model must be callable; got {f!r}")
        self.likelihood = likelihood
        self.forward_model = f

    @property
    def lsm_tangents_shape(self):
        return self.likelihood.lsm_tangents_shape

    def energy(self, primals):
        return self.likelihood.energy(self.forward_model(primals))

    def normalized_residual(self, primals):
        return self.likelihood.normalized_residual(self.forward_model(primals))

    def transformation(self, primals):
        return self.likelihood.transformation(self.forward_model(primals))

    def metric(self, primals, tangents):
        y, f_t = torch.func.jvp(self.forward_model, (primals,), (tangents,))
        _, vjp_fn = torch.func.vjp(self.forward_model, primals)
        return vjp_fn(self.likelihood.metric(y, f_t))[0]

    def left_sqrt_metric(self, primals, tangents):
        y, vjp_fn = torch.func.vjp(self.forward_model, primals)
        return vjp_fn(self.likelihood.left_sqrt_metric(y, tangents))[0]

    def right_sqrt_metric(self, primals, tangents):
        y, f_t = torch.func.jvp(self.forward_model, (primals,), (tangents,))
        return self.likelihood.right_sqrt_metric(y, f_t)


def frozen_keys(point_estimates) -> set:
    """The keys to hold fixed: a tuple of names, or a dict of booleans."""
    if isinstance(point_estimates, dict):
        return {k for k, v in point_estimates.items() if v}
    return set(point_estimates)


class LikelihoodPartial(Likelihood):
    """A likelihood with some keys of its position fixed (point estimates).
    It takes positions and tangents of the other keys; the fixed keys are
    inserted into every call, their tangents as zeros, and stripped from
    the outputs in parameter space."""

    def __init__(self, likelihood: Likelihood, *, primals, point_estimates):
        super().__init__()
        self.likelihood = likelihood
        keys = frozen_keys(point_estimates)
        missing = keys - set(primals)
        if missing:
            raise ValueError(f"point estimates {sorted(missing)} not in primals")
        self.frozen = {k: v for k, v in primals.items() if k in keys}

    @property
    def lsm_tangents_shape(self):
        return self.likelihood.lsm_tangents_shape

    def liquid(self, tree):
        """``tree`` without the fixed keys."""
        return {k: v for k, v in tree.items() if k not in self.frozen}

    def _full(self, primals):
        return {**primals, **self.frozen}

    def _full_tangents(self, tangents):
        return {**tangents, **{k: torch.zeros_like(v) for k, v in self.frozen.items()}}

    def energy(self, primals):
        return self.likelihood.energy(self._full(primals))

    def normalized_residual(self, primals):
        return self.likelihood.normalized_residual(self._full(primals))

    def transformation(self, primals):
        return self.likelihood.transformation(self._full(primals))

    def metric(self, primals, tangents):
        full = self.likelihood.metric(self._full(primals), self._full_tangents(tangents))
        return self.liquid(full)

    def left_sqrt_metric(self, primals, tangents):
        return self.liquid(self.likelihood.left_sqrt_metric(self._full(primals), tangents))

    def right_sqrt_metric(self, primals, tangents):
        return self.likelihood.right_sqrt_metric(
            self._full(primals), self._full_tangents(tangents)
        )


class StandardHamiltonian(torch.nn.Module):
    """A likelihood plus the standard-normal prior of its latent position:
    H(ξ) = E(ξ) + ½‖ξ‖²; its metric is the likelihood's plus the identity."""

    def __init__(self, likelihood: Likelihood):
        super().__init__()
        self.likelihood = likelihood

    def forward(self, primals):
        return self.energy(primals)

    def energy(self, primals):
        return self.likelihood.energy(primals) + 0.5 * vdot(primals, primals).real

    def metric(self, primals, tangents):
        return tree_map(torch.add, self.likelihood.metric(primals, tangents), tangents)
