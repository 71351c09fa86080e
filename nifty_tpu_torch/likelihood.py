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

The LSM is torch's vjp, which conjugates: on complex data it is the
adjoint J^H that the JAX package gets by conjugating the inputs and the
output of its vjp; the RSM is the LSM's transpose, as there.

Positions are dicts of tensors.  :meth:`Likelihood.freeze` fixes some of
their keys (point estimates): the :class:`LikelihoodPartial` it returns
takes and returns dicts of the other keys only.  Likelihoods add up
(:class:`LikelihoodSum`); the data-space trees of the terms are joined
under the keys ``lh_0``, ``lh_1``, ...

Keyword arguments of the methods go to ``transformation`` (the base
class) or, for a likelihood with a model, to the forward model, except
those named in ``amend(..., likelihood_argnames=...)``, which go to the
likelihood.  :func:`partial_insert_and_remove` fixes some leaves of a
function's arguments and strips some from its output.
"""

from __future__ import annotations

from functools import partial, reduce
from typing import Callable

import torch
from torch.utils._pytree import tree_leaves, tree_structure, tree_unflatten

from . import tracing
from .model import ChainModel, Model
from .utils.tree import ShapeWithDtype, tree_add, tree_map, vdot

__all__ = [
    "Likelihood",
    "LikelihoodPartial",
    "LikelihoodSum",
    "LikelihoodWithModel",
    "StandardHamiltonian",
    "partial_insert_and_remove",
]


def _partial_argument(call, insert_axes, flat_fill):
    """``call`` with the leaves flagged True in ``insert_axes[i]`` (a tree of
    booleans, or None for an argument left whole) of its ``i``-th argument
    taken, in order, from ``flat_fill[i]``; the argument passed carries only
    the other leaves (as a flat sequence or any tree of them).  An
    ``insert_axes`` of Nones returns ``call`` itself (the JAX package tests
    ``any(insert_axes)``, which raises for a ``Vector``)."""
    if all(axes is None for axes in insert_axes):
        return call
    metas = []
    for axes, fill in zip(insert_axes, flat_fill):
        if axes is None:
            metas.append(None)
            continue
        metas.append((tree_leaves(axes), tree_structure(axes), tuple(fill)))

    def inserted(*args):
        full = []
        for arg, meta in zip(args, metas):
            if meta is None:
                full.append(arg)
                continue
            flags, struct, fill = meta
            liquid, frozen = iter(tree_leaves(arg)), iter(fill)
            full.append(tree_unflatten([next(frozen) if f else next(liquid) for f in flags],
                                       struct))
        return call(*full)

    return inserted


def partial_insert_and_remove(call, insert_axes, flat_fill, *, remove_axes=(), unflatten=None):
    """Insert ``flat_fill`` into ``call``'s arguments at ``insert_axes`` (see
    :func:`_partial_argument`) and strip the leaves flagged True in
    ``remove_axes`` (a tree of booleans over the output) from its output,
    returning the kept leaves as a tuple or through ``unflatten``."""
    if insert_axes is not None:
        call = _partial_argument(call, insert_axes=insert_axes, flat_fill=flat_fill)
    if not remove_axes:
        return call
    flags = tree_leaves(remove_axes)
    spec = tree_structure(remove_axes)

    def removed(*args):
        leaves = spec.flatten_up_to(call(*args))
        kept = tuple(x for x, f in zip(leaves, flags) if not f)
        return unflatten(kept) if unflatten is not None else kept

    return removed


def _is_shape(x):
    return isinstance(x, ShapeWithDtype)


def _zeros(shapes, like):
    """Zeros shaped like the tree of :class:`ShapeWithDtype` ``shapes`` on
    the device of the tensor ``like``; a leaf without a dtype takes the
    real dtype of ``like``."""
    return tree_map(
        lambda s: torch.zeros(s.shape, dtype=s.dtype or like.real.dtype, device=like.device),
        shapes,
        is_leaf=_is_shape,
    )


class Likelihood(torch.nn.Module):
    """Negative log-likelihood with metric algebra.  Subclasses implement
    ``energy`` and, for the metric, ``transformation`` or the metric
    methods themselves.  Data are buffers, so ``.to`` moves them.

    ``lsm_tangents_shape`` (also ``left_sqrt_metric_tangents_shape``) is the
    tree of :class:`ShapeWithDtype` of the data-space tangents that the
    left square root of the metric takes: the data's shape and, for
    floating or complex data, its dtype.  A leaf without a dtype (count
    data, say) is drawn in the real dtype of the position."""

    def forward(self, primals, **kw):
        return self.energy(primals, **kw)

    @property
    def lsm_tangents_shape(self):
        d = self.data
        return ShapeWithDtype(tuple(d.shape), d.dtype if d.is_floating_point() or d.is_complex() else None)

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

    def metric(self, primals, tangents, **kw):
        """Fisher metric applied to ``tangents`` at ``primals`` (LSM ∘ RSM)."""
        return self.left_sqrt_metric(primals, self.right_sqrt_metric(primals, tangents, **kw), **kw)

    def left_sqrt_metric(self, primals, tangents, **kw):
        """Pull-back of data-space tangents: the vjp of ``transformation``."""
        _, vjp_fn = torch.func.vjp(partial(self.transformation, **kw), primals)
        return vjp_fn(tangents)[0]

    def right_sqrt_metric(self, primals, tangents, **kw):
        """Push-forward of parameter tangents: the transpose of the LSM (the
        vjp of the LSM, linear in its tangents, at zero tangents)."""
        zeros = _zeros(self.lsm_tangents_shape, tree_leaves(primals)[0])
        _, vjp_fn = torch.func.vjp(partial(self.left_sqrt_metric, primals, **kw), zeros)
        return vjp_fn(tangents)[0]

    def amend(self, f: Callable, *, likelihood_argnames=None) -> "LikelihoodWithModel":
        """Compose a forward model to the right of the likelihood; keyword
        arguments named in ``likelihood_argnames`` go to the likelihood, the
        others to ``f``."""
        return LikelihoodWithModel(self, f, likelihood_argnames=likelihood_argnames)

    def __add__(self, other) -> "LikelihoodSum":
        return LikelihoodSum(self, other)


class LikelihoodWithModel(Likelihood):
    """A likelihood composed with a forward model ``f`` (lh ∘ f).  Keyword
    arguments of its methods named in ``likelihood_argnames`` go to the
    likelihood, the others to ``f``."""

    def __init__(self, likelihood: Likelihood, f: Callable, *, likelihood_argnames=None):
        super().__init__()
        if not callable(f):
            raise TypeError(f"forward model must be callable; got {f!r}")
        argnames = () if likelihood_argnames is None else likelihood_argnames
        if not isinstance(argnames, (tuple, list)):
            raise TypeError(f"invalid likelihood_argnames {likelihood_argnames!r}")
        self.likelihood = likelihood
        self.forward_model = f
        self.likelihood_argnames = tuple(argnames)

    @property
    def lsm_tangents_shape(self):
        return self.likelihood.lsm_tangents_shape

    def _split(self, kw):
        """``(likelihood kwargs, forward-model call)``."""
        kl = {k: kw.pop(k) for k in self.likelihood_argnames if k in kw}
        return kl, (partial(self.forward_model, **kw) if kw else self.forward_model)

    def energy(self, primals, **kw):
        kl, fwd = self._split(kw)
        return self.likelihood.energy(fwd(primals), **kl)

    def normalized_residual(self, primals, **kw):
        kl, fwd = self._split(kw)
        return self.likelihood.normalized_residual(fwd(primals), **kl)

    def transformation(self, primals, **kw):
        kl, fwd = self._split(kw)
        return self.likelihood.transformation(fwd(primals), **kl)

    @tracing.span("likelihood.metric")
    def metric(self, primals, tangents, **kw):
        kl, fwd = self._split(kw)
        y, f_t = torch.func.jvp(fwd, (primals,), (tangents,))
        _, vjp_fn = torch.func.vjp(fwd, primals)
        return vjp_fn(self.likelihood.metric(y, f_t, **kl))[0]

    def left_sqrt_metric(self, primals, tangents, **kw):
        kl, fwd = self._split(kw)
        y, vjp_fn = torch.func.vjp(fwd, primals)
        return vjp_fn(self.likelihood.left_sqrt_metric(y, tangents, **kl))[0]

    def right_sqrt_metric(self, primals, tangents, **kw):
        kl, fwd = self._split(kw)
        y, f_t = torch.func.jvp(fwd, (primals,), (tangents,))
        return self.likelihood.right_sqrt_metric(y, f_t, **kl)

    def amend(self, f: Callable, *, likelihood_argnames=None) -> "LikelihoodWithModel":
        """Compose ``f`` before this forward model; the likelihood's
        argument names stay unless given anew."""
        fwd = self.forward_model
        chained = (ChainModel(fwd, f) if isinstance(f, Model)
                   else lambda x, **kw: fwd(f(x, **kw)))
        names = self.likelihood_argnames if likelihood_argnames is None else likelihood_argnames
        return LikelihoodWithModel(self.likelihood, chained, likelihood_argnames=names)


class LikelihoodSum(Likelihood):
    """A sum of likelihoods of one position.  The data-space trees of the
    terms (their transformations, normalized residuals and LSM tangents)
    are joined under the keys ``lh_{i}``; a sum of sums is flattened."""

    def __init__(self, *likelihood_summands):
        super().__init__()
        flat = []
        for lh in likelihood_summands:
            if isinstance(lh, LikelihoodSum):
                flat.extend(lh.likelihood_summands)
            elif isinstance(lh, Likelihood):
                flat.append(lh)
            else:
                raise TypeError(f"object of type {type(lh)} is not a Likelihood")
        self.likelihood_summands = torch.nn.ModuleList(flat)

    @staticmethod
    def _key(index):
        return f"lh_{index}"

    def _joined(self, fn):
        return {self._key(i): fn(lh) for i, lh in enumerate(self.likelihood_summands)}

    @property
    def lsm_tangents_shape(self):
        return self._joined(lambda lh: lh.lsm_tangents_shape)

    def energy(self, primals):
        return sum(lh.energy(primals) for lh in self.likelihood_summands)

    def normalized_residual(self, primals):
        return self._joined(lambda lh: lh.normalized_residual(primals))

    def transformation(self, primals):
        return self._joined(lambda lh: lh.transformation(primals))

    def metric(self, primals, tangents):
        return reduce(tree_add, [lh.metric(primals, tangents) for lh in self.likelihood_summands])

    def left_sqrt_metric(self, primals, tangents):
        terms = [lh.left_sqrt_metric(primals, tangents[self._key(i)])
                 for i, lh in enumerate(self.likelihood_summands)]
        return reduce(tree_add, terms)

    def right_sqrt_metric(self, primals, tangents):
        return self._joined(lambda lh: lh.right_sqrt_metric(primals, tangents))


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
