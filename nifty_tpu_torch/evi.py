"""Posterior samples for MGVI and geoVI (counterpart of ``nifty_tpu/evi.py``).

An MGVI residual: draw white noise d̃ in data space and ξ̃ in latent space;
t = L d̃ + ξ̃ (L the likelihood's left square root of the metric) has the
Hamiltonian metric M = M_lh + 𝟙 as covariance, so s = M⁻¹ t, solved by CG
from ξ̃, is a draw with covariance M⁻¹, the approximate posterior's.  A
geoVI residual refines it: Newton-CG on the nonlinear residual in the
coordinates where the likelihood's metric is Euclidean.

Randomness: a sample's ``key`` is an integer seed, from which
:func:`white_noise` draws d̃ then ξ̃ with a :class:`torch.Generator` on the
position's device.  A seed replays: geoVI draws its metric sample from the
same key as the linear residual.  Every sampler also
takes the draws themselves (``white=``), so a test can hand both packages
the same numbers.  Positions are dicts of tensors; point estimates are
keys held fixed, whose residuals are zeros.
"""

from __future__ import annotations

from functools import partial
from typing import Any, Callable, NamedTuple, Optional

import torch
from torch.utils._pytree import tree_leaves

from . import conjugate_gradient, optimize
from .likelihood import Likelihood, frozen_keys
from .utils.tree import ShapeWithDtype, random_like, stack, tree_add, tree_map, tree_sub, vdot

__all__ = [
    "Samples",
    "WhiteNoise",
    "concatenate_zip",
    "draw_linear_residual",
    "draw_residual",
    "nonlinearly_update_residual",
    "sample_likelihood",
    "white_noise",
]


class WhiteNoise(NamedTuple):
    """Standard-normal draws of one residual: ``data`` shaped like the
    likelihood's data-space tangents, ``prior`` like the liquid position."""

    data: Any
    prior: Any


def white_noise(likelihood: Likelihood, pos, key, point_estimates=()) -> WhiteNoise:
    """The white draws of a residual at ``pos`` from ``key``, in the
    position's dtype and on its device."""
    lh, p_liquid = likelihood.freeze(primals=pos, point_estimates=point_estimates)
    leaf = tree_leaves(p_liquid)[0]
    gen = torch.Generator(device=leaf.device).manual_seed(int(key))
    draw = partial(random_like, gen, device=leaf.device, dtype=leaf.dtype)
    data = draw(lh.lsm_tangents_shape)
    prior = draw(tree_map(lambda x: ShapeWithDtype(x.shape), p_liquid))
    return WhiteNoise(data, prior)


def _strip(tree, point_estimates):
    """``tree`` without the point-estimated keys."""
    frozen = frozen_keys(point_estimates)
    return {k: v for k, v in tree.items() if k not in frozen}


def _with_zeros(tree, pos):
    """``tree`` with zero residuals at the keys of ``pos`` it lacks (the
    point estimates)."""
    return {k: tree[k] if k in tree else torch.zeros_like(v) for k, v in pos.items()}


def sample_likelihood(likelihood: Likelihood, point_estimates, primals, white_data):
    """``L d̃``: data-space white noise pulled back to the latent space, a
    draw with the likelihood's metric as covariance."""
    lh, p_liquid = likelihood.freeze(primals=primals, point_estimates=point_estimates)
    return lh.left_sqrt_metric(p_liquid, white_data)


def _ham_metric(likelihood, point_estimates, primals, tangents):
    lh, p_liquid = likelihood.freeze(primals=primals, point_estimates=point_estimates)
    return tree_add(lh.metric(p_liquid, tangents), tangents)


def draw_linear_residual(
    likelihood: Likelihood,
    pos,
    key=None,
    *,
    white: Optional[WhiteNoise] = None,
    from_inverse: bool = True,
    point_estimates=(),
    cg: Callable = conjugate_gradient.static_cg,
    cg_name: Optional[str] = None,
    cg_kwargs: Optional[dict] = None,
):
    """One MGVI residual at ``pos``: ``(residual, CG info)``; with
    ``from_inverse=False`` the metric sample t itself (info 0)."""
    if not isinstance(likelihood, Likelihood):
        raise TypeError(f"`likelihood` of invalid type {type(likelihood)!r}")
    if white is None:
        white = white_noise(likelihood, pos, key, point_estimates)
    smpl = tree_add(sample_likelihood(likelihood, point_estimates, pos, white.data), white.prior)
    info = 0
    if from_inverse:
        met = partial(_ham_metric, likelihood, point_estimates, pos)
        res = cg(met, smpl, x0=white.prior, name=cg_name, **(cg_kwargs or {}))
        smpl, info = res.x, res.info
    return _with_zeros(smpl, pos), info


def _nonlinear_residual_vg(likelihood, point_estimates, e, lh_trafo_at_p, ms_at_p, x):
    """Value and negative gradient of ½‖r‖², r the geoVI residual of ``x``
    against the metric sample ``ms_at_p`` at the expansion point ``e``."""
    lh, e_liquid = likelihood.freeze(primals=e, point_estimates=point_estimates)
    t = tree_sub(lh.transformation(x), lh_trafo_at_p)
    g = tree_add(tree_sub(x, e_liquid), lh.left_sqrt_metric(e_liquid, t))
    r = tree_sub(ms_at_p, g)
    res = 0.5 * vdot(r, r).real
    ngrad = tree_add(r, lh.left_sqrt_metric(x, lh.right_sqrt_metric(e_liquid, r)))
    return res, tree_map(torch.neg, ngrad)


def _nonlinear_residual_metric(likelihood, point_estimates, e, primals, tangents):
    lh, e_liquid = likelihood.freeze(primals=e, point_estimates=point_estimates)
    lsm, rsm = lh.left_sqrt_metric, lh.right_sqrt_metric
    tm = tree_add(lsm(e_liquid, rsm(primals, tangents)), tangents)
    return tree_add(lsm(primals, rsm(e_liquid, tm)), tm)


def _nonlinear_residual_sampnorm(likelihood, point_estimates, e, natgrad):
    lh, e_liquid = likelihood.freeze(primals=e, point_estimates=point_estimates)
    fpp = lh.right_sqrt_metric(e_liquid, natgrad)
    return torch.sqrt(vdot(natgrad, natgrad).real + vdot(fpp, fpp).real)


def nonlinearly_update_residual(
    likelihood: Likelihood,
    pos,
    residual_sample,
    metric_sample_key=None,
    metric_sample_sign=1.0,
    *,
    white: Optional[WhiteNoise] = None,
    point_estimates=(),
    minimize: Callable = optimize.static_newton_cg,
    minimize_kwargs: Optional[dict] = None,
):
    """The geoVI update of a linear residual: ``(residual, OptimizeResults)``
    (its ``x`` and ``jac`` dropped).  The metric sample is drawn from
    ``metric_sample_key`` (or ``white``), the draws of the linear residual,
    times ``metric_sample_sign``."""
    minimize_kwargs = dict(minimize_kwargs or {})
    sample = _strip(tree_add(pos, residual_sample), point_estimates)
    metric_sample, _ = draw_linear_residual(
        likelihood, pos, metric_sample_key, white=white, from_inverse=False,
        point_estimates=point_estimates,
    )
    metric_sample = _strip(
        tree_map(lambda x: metric_sample_sign * x, metric_sample), point_estimates
    )
    if minimize_kwargs.get("maxiter") == 0:
        opt_state = optimize.OptimizeResults(sample, True, 0, None, None)
    else:
        lh, e_liquid = likelihood.freeze(primals=pos, point_estimates=point_estimates)
        at = (likelihood, point_estimates, pos)
        opt_state = minimize(
            None,
            x0=sample,
            **minimize_kwargs,
            fun_and_grad=partial(
                _nonlinear_residual_vg, *at, lh.transformation(e_liquid), metric_sample
            ),
            hessp=partial(_nonlinear_residual_metric, *at),
            custom_gradnorm=partial(_nonlinear_residual_sampnorm, *at),
        )
    residual = tree_sub(opt_state.x, _strip(pos, point_estimates))
    return _with_zeros(residual, pos), opt_state._replace(x=None, jac=None)


def draw_residual(
    likelihood: Likelihood,
    pos,
    key,
    *,
    point_estimates=(),
    cg: Callable = conjugate_gradient.static_cg,
    cg_name=None,
    cg_kwargs=None,
    minimize: Callable = optimize.static_newton_cg,
    minimize_kwargs=None,
):
    """An antithetic pair of geoVI residuals from one key, stacked:
    ``(residuals, (state of +, state of −))``."""
    residual, _ = draw_linear_residual(
        likelihood, pos, key, point_estimates=point_estimates, cg=cg, cg_name=cg_name,
        cg_kwargs=cg_kwargs,
    )
    curve = partial(
        nonlinearly_update_residual, likelihood, pos, metric_sample_key=key,
        point_estimates=point_estimates, minimize=minimize, minimize_kwargs=minimize_kwargs,
    )
    plus, plus_state = curve(residual, metric_sample_sign=1.0)
    minus, minus_state = curve(tree_map(torch.neg, residual), metric_sample_sign=-1.0)
    return stack([plus, minus]), (plus_state, minus_state)


def concatenate_zip(*trees):
    """Interleave equal-structure forests along their leading axis:
    ``(a0, b0, a1, b1, ...)``."""
    return tree_map(
        lambda *xs: torch.stack(xs, dim=1).reshape((-1,) + tuple(xs[0].shape[1:])), *trees
    )


class Samples:
    """Posterior samples as residuals (a forest: each leaf with a leading
    sample axis) around an expansion point ``pos``; ``keys`` are the seeds
    they were drawn from, one per mirrored pair."""

    def __init__(self, *, pos=None, samples=None, keys=None):
        self._pos, self._samples, self._keys = pos, samples, keys

    @property
    def pos(self):
        return self._pos

    @property
    def keys(self):
        return self._keys

    @property
    def samples(self):
        """The samples themselves, ``pos`` plus each residual, as a forest."""
        if self._samples is None:
            raise ValueError(f"{type(self).__name__} has no samples")
        if self._pos is None:
            return self._samples
        return tree_map(lambda p, s: p.unsqueeze(0) + s, self._pos, self._samples)

    def __len__(self):
        if self._samples is None:
            return 0
        return tree_leaves(self._samples)[0].shape[0]

    def __getitem__(self, index):
        if self._samples is None:
            raise ValueError(f"{type(self).__name__} has no samples")
        if self._pos is None:
            return tree_map(lambda s: s[index], self._samples)
        return tree_map(lambda p, s: p + s[index], self._pos, self._samples)

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    def at(self, pos, old_pos=None):
        """The same residuals around ``pos`` (or, given ``old_pos``, the same
        samples, their residuals taken anew from ``pos``)."""
        if old_pos is None:
            if self._pos is None:
                raise ValueError("invalid combination of `pos` and `old_pos`")
            return Samples(pos=pos, samples=self._samples, keys=self._keys)
        smpls = tree_map(lambda p, s: s - p.unsqueeze(0), old_pos, self.samples)
        return Samples(pos=pos, samples=smpls, keys=self._keys)
