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
"""

from __future__ import annotations

from typing import Callable

import torch

__all__ = ["Likelihood", "LikelihoodWithModel"]


class Likelihood(torch.nn.Module):
    """Negative log-likelihood with metric algebra.  Subclasses implement
    ``energy`` and, for the metric, ``transformation`` or the metric
    methods themselves.  Data are buffers, so ``.to`` moves them."""

    def forward(self, primals):
        return self.energy(primals)

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
