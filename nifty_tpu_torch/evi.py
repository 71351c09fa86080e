"""Posterior samples for MGVI and geoVI (counterpart of ``nifty_tpu/evi.py``).

An MGVI residual: draw white noise d̃ in data space and ξ̃ in latent space;
t = L d̃ + ξ̃ (L the likelihood's left square root of the metric) has the
Hamiltonian metric M = M_lh + 𝟙 as covariance, so s = M⁻¹ t, solved by CG
from ξ̃, is a draw with covariance M⁻¹, the approximate posterior's.  A
geoVI residual refines it: Newton-CG on the nonlinear residual in the
coordinates where the likelihood's metric is Euclidean.

Randomness: a sample's ``key`` is an integer seed, from which
:func:`white_noise` draws d̃ then ξ̃ on the position's device by the
counter-based K7 (Philox-4x32-10): each entry a function of the seed, its
leaf and its index in the whole leaf, so a rank of a field-sharded run
draws only its rows and gets those of the one-process draw.  A seed
replays: geoVI draws its metric sample from the same key as the linear
residual.  Every sampler also
takes the draws themselves (``white=``), so a test can hand both packages
the same numbers.  Positions are dicts of tensors; point estimates are
keys held fixed, whose residuals are zeros.

Many samples at once: :func:`draw_linear_residuals` and
:func:`nonlinearly_update_residuals` take one key per sample and map the
samples by ``residual_map``.  They draw every sample's white noise first,
from its key, so every map gives the same samples.  There is one
implementation of each sampler, on an explicit leading sample axis: the
control flow is the batched :func:`~.conjugate_gradient.static_cg` or
:func:`~.optimize.static_newton_cg` (per-sample scalars, masked updates),
and only the operators, the metric and the energy with its gradient, go
through ``torch.func.vmap``, so each kernel runs once per batch.
``"vmap"`` (the default) runs all samples as one batch; ``"lmap"`` loops
over batches of one, which are what the single-sample
:func:`draw_linear_residual` and :func:`nonlinearly_update_residual` run.
"""

from __future__ import annotations

from functools import partial
from typing import Any, Callable, NamedTuple, Optional

import inspect
import itertools
import math

import numpy as np
import torch
from torch.utils._pytree import tree_leaves

from . import conjugate_gradient, optimize, tracing
from .interop import position_from_numpy
from .likelihood import Likelihood, LikelihoodWithModel, frozen_keys
from .utils.tree import (
    ShapeWithDtype,
    counter_normal,
    get_map,
    stack,
    tree_add,
    tree_map,
    tree_sub,
    vdot,
    vmap,
)

__all__ = [
    "Samples",
    "WhiteNoise",
    "concatenate_zip",
    "draw_linear_residual",
    "draw_linear_residuals",
    "draw_residual",
    "nonlinearly_update_residual",
    "nonlinearly_update_residuals",
    "sample_likelihood",
    "seeds",
    "white_noise",
    "wiener_filter_posterior",
]


class WhiteNoise(NamedTuple):
    """Standard-normal draws of one residual: ``data`` shaped like the
    likelihood's data-space tangents, ``prior`` like the liquid position."""

    data: Any
    prior: Any


@tracing.span("noise")
def white_noise(likelihood: Likelihood, pos, key, point_estimates=()) -> WhiteNoise:
    """The white draws of a residual at ``pos`` from ``key``, on the
    position's device: the data-space draws in the dtypes of the
    likelihood's ``lsm_tangents_shape`` (complex normals for complex data;
    the position's real dtype where it names none), the prior draws in the
    position's.  Every leaf is drawn by the counter-based K7
    (:func:`~.utils.tree.counter_normal`) from ``key`` and its index in
    draw order (the data leaves, then the prior's).  In a field-sharded run
    a split leaf (the data, the field's rows of ξ) draws only the rank's
    block, its entries at their indices in the whole leaf (a data leaf's
    block starts after the lower ranks' shares, which may be a point
    longer: one ``all_gather`` of the shares' lengths): the rows of the
    one-process draw, bit for bit, without making the rest."""
    from .parallel.collectives import field, share_starts

    lh, p_liquid = likelihood.freeze(primals=pos, point_estimates=point_estimates)
    leaf = tree_leaves(p_liquid)[0]
    ctx = field()
    rank = 0 if ctx is None else torch.distributed.get_rank(ctx.group)
    order = itertools.count()
    is_shape = lambda x: isinstance(x, ShapeWithDtype)  # noqa: E731
    starts = iter(())
    if ctx is not None:  # a response's shares may differ by a point: where each begins
        starts = iter(share_starts([s.shape[0] if s.shape else 1 for s in
                                    tree_leaves(lh.lsm_tangents_shape, is_leaf=is_shape)], ctx.group))

    def draw(s, start):
        return counter_normal(int(key), next(order), s.shape, s.dtype or leaf.real.dtype,
                              start=start, device=leaf.device)

    data = tree_map(lambda s: draw(s, next(starts, 0) * math.prod(s.shape[1:])),
                    lh.lsm_tangents_shape, is_leaf=is_shape)
    if ctx is None:
        prior = tree_map(lambda v: draw(ShapeWithDtype.from_leave(v), 0), p_liquid)
    else:
        prior = {k: draw(ShapeWithDtype.from_leave(v), rank * v.numel() if k in ctx.keys else 0)
                 for k, v in p_liquid.items()}
    return WhiteNoise(data, prior)


def seeds(generator: torch.Generator, n: int) -> list:
    """``n`` integer seeds from ``generator``, one a sample (pair)."""
    draw = torch.randint(0, 2**62, (n,), generator=generator, device=generator.device)
    return tracing.host_read(draw)  # a blocking read where the generator is the card's


def _white_noises(likelihood, pos, keys, point_estimates) -> WhiteNoise:
    """The :func:`white_noise` of each key, stacked along a leading axis."""
    return stack([white_noise(likelihood, pos, k, point_estimates) for k in keys])


def _strip(tree, point_estimates):
    """``tree`` without the point-estimated keys."""
    frozen = frozen_keys(point_estimates)
    return {k: v for k, v in tree.items() if k not in frozen}


def _with_zeros(tree, pos, batch=()):
    """``tree`` with zero residuals at the keys of ``pos`` it lacks (the
    point estimates), with the leading axes ``batch`` for a forest."""
    return {
        k: tree[k] if k in tree else v.new_zeros(tuple(batch) + tuple(v.shape))
        for k, v in pos.items()
    }


def _is_vmap(residual_map) -> bool:
    """Whether ``residual_map`` asks for one batch of all samples."""
    return isinstance(residual_map, str) and residual_map.lower() == "vmap"


def _batched_solver(fn, what):
    """Raise unless the solver ``fn`` has a batched form (a ``batched``
    keyword): the samplers run the samples' control flow on a sample axis,
    a batch of one under a loop."""
    if "batched" not in inspect.signature(fn).parameters:
        raise TypeError(
            f"the samplers need a {what} with a batched form (a `batched` keyword, as "
            f"the static_* solvers have); {getattr(fn, '__name__', fn)!r} solves one "
            "sample at a time"
        )


def _batch_of_one(tree):
    return tree_map(lambda x: x.unsqueeze(0), tree)


def _only(tree):
    """The one sample of a batch of one (empty fields stay empty)."""
    return tree_map(lambda x: None if x is None else x[0], tree)


def sample_likelihood(likelihood: Likelihood, point_estimates, primals, white_data):
    """``L d̃``: data-space white noise pulled back to the latent space, a
    draw with the likelihood's metric as covariance."""
    lh, p_liquid = likelihood.freeze(primals=primals, point_estimates=point_estimates)
    return lh.left_sqrt_metric(p_liquid, white_data)


def _ham_metric(likelihood, point_estimates, primals, tangents):
    lh, p_liquid = likelihood.freeze(primals=primals, point_estimates=point_estimates)
    return tree_add(lh.metric(p_liquid, tangents), tangents)


def _draw_linear(likelihood, pos, white, *, from_inverse, point_estimates, cg, cg_name,
                 cg_kwargs):
    """The MGVI residuals of the stacked draws ``white`` as one batch:
    ``(residuals, CG infos)``, each with a leading sample axis."""
    n = tree_leaves(white.data)[0].shape[0]
    smpl = tree_add(vmap(partial(sample_likelihood, likelihood, point_estimates, pos))(white.data),
                    white.prior)
    info = torch.zeros(n, dtype=torch.int32, device=tree_leaves(pos)[0].device)
    if from_inverse:
        _batched_solver(cg, "cg")
        met = vmap(partial(_ham_metric, likelihood, point_estimates, pos))
        res = cg(met, smpl, x0=white.prior, name=cg_name, batched=True, **(cg_kwargs or {}))
        smpl, info = res.x, res.info
    return _with_zeros(smpl, pos, (n,)), info


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
    ``from_inverse=False`` the metric sample t itself (info 0).  A batch of
    one of :func:`draw_linear_residuals`."""
    if not isinstance(likelihood, Likelihood):
        raise TypeError(f"`likelihood` of invalid type {type(likelihood)!r}")
    if white is None:
        white = white_noise(likelihood, pos, key, point_estimates)
    return _only(_draw_linear(
        likelihood, pos, _batch_of_one(white), from_inverse=from_inverse,
        point_estimates=point_estimates, cg=cg, cg_name=cg_name, cg_kwargs=cg_kwargs,
    ))


def draw_linear_residuals(
    likelihood: Likelihood,
    pos,
    keys=None,
    *,
    white: Optional[WhiteNoise] = None,
    residual_map="vmap",
    from_inverse: bool = True,
    point_estimates=(),
    cg: Callable = conjugate_gradient.static_cg,
    cg_name: Optional[str] = None,
    cg_kwargs: Optional[dict] = None,
):
    """MGVI residuals at ``pos``, one a key (or a sample of the stacked
    draws ``white``): ``(residuals, CG infos)``, each with a leading sample
    axis.  ``residual_map="vmap"`` solves the samples as one batch;
    ``"lmap"`` or a callable map maps :func:`draw_linear_residual` over
    them.  ``cg`` needs a batched form."""
    if white is None:
        white = _white_noises(likelihood, pos, keys, point_estimates)
    draw = partial(_draw_linear, likelihood, pos, from_inverse=from_inverse,
                   point_estimates=point_estimates, cg=cg, cg_name=cg_name, cg_kwargs=cg_kwargs)
    if _is_vmap(residual_map):
        return draw(white)
    return get_map(residual_map)(lambda w: _only(draw(_batch_of_one(WhiteNoise(*w)))))(white)


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


def _update_nonlinear(likelihood, pos, residuals, white, signs, *, point_estimates, minimize,
                      minimize_kwargs):
    """The geoVI update of the forest ``residuals`` as one batch, the metric
    samples from the stacked draws ``white`` times ``signs``: ``(residuals,
    OptimizeResults)``, each field with a leading sample axis (``x`` and
    ``jac`` dropped)."""
    minimize_kwargs = dict(minimize_kwargs or {})
    n = tree_leaves(residuals)[0].shape[0]
    sample = _strip(tree_add(pos, residuals), point_estimates)
    metric_sample, _ = _draw_linear(likelihood, pos, white, from_inverse=False,
                                    point_estimates=point_estimates, cg=None, cg_name=None,
                                    cg_kwargs=None)
    metric_sample = _strip(
        tree_map(lambda x: signs.to(x).reshape((n,) + (1,) * (x.ndim - 1)) * x, metric_sample),
        point_estimates,
    )
    if minimize_kwargs.get("maxiter") == 0:
        opt_state = optimize.OptimizeResults(
            sample, torch.ones(n, dtype=torch.bool), torch.zeros(n, dtype=torch.int32), None, None
        )
    else:
        _batched_solver(minimize, "minimize")
        lh, e_liquid = likelihood.freeze(primals=pos, point_estimates=point_estimates)
        at = (likelihood, point_estimates, pos)
        vg = vmap(partial(_nonlinear_residual_vg, *at, lh.transformation(e_liquid)))
        opt_state = minimize(
            None,
            x0=sample,
            **minimize_kwargs,
            fun_and_grad=partial(vg, metric_sample),
            hessp=vmap(partial(_nonlinear_residual_metric, *at)),
            custom_gradnorm=vmap(partial(_nonlinear_residual_sampnorm, *at)),
            batched=True,
        )
    residual = tree_sub(opt_state.x, _strip(pos, point_estimates))
    return _with_zeros(residual, pos, (n,)), opt_state._replace(x=None, jac=None)


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
    times ``metric_sample_sign``.  A batch of one of
    :func:`nonlinearly_update_residuals`."""
    if white is None:
        white = white_noise(likelihood, pos, metric_sample_key, point_estimates)
    return _only(_update_nonlinear(
        likelihood, pos, _batch_of_one(residual_sample), _batch_of_one(white),
        torch.tensor([float(metric_sample_sign)], dtype=torch.float64),
        point_estimates=point_estimates, minimize=minimize, minimize_kwargs=minimize_kwargs,
    ))


def nonlinearly_update_residuals(
    likelihood: Likelihood,
    pos,
    residuals,
    keys=None,
    signs=None,
    *,
    white: Optional[WhiteNoise] = None,
    residual_map="vmap",
    point_estimates=(),
    minimize: Callable = optimize.static_newton_cg,
    minimize_kwargs: Optional[dict] = None,
):
    """The geoVI update of each residual of the forest ``residuals``, its
    metric sample drawn from its key (or its sample of the stacked
    ``white``) times its sign: ``(residuals, [OptimizeResults of each
    sample])``.  ``residual_map="vmap"`` runs the Newton-CGs as one batch;
    ``"lmap"`` or a callable map maps :func:`nonlinearly_update_residual`
    over them.  ``minimize`` needs a batched form."""
    n = tree_leaves(residuals)[0].shape[0]
    if white is None:
        white = _white_noises(likelihood, pos, keys, point_estimates)
    signs = torch.as_tensor([1.0] * n if signs is None else signs, dtype=torch.float64)
    update = partial(_update_nonlinear, likelihood, pos, point_estimates=point_estimates,
                     minimize=minimize, minimize_kwargs=minimize_kwargs)
    if _is_vmap(residual_map):
        out, state = update(residuals, white, signs)
    else:
        def one(r, w, sign):
            return _only(update(_batch_of_one(r), _batch_of_one(WhiteNoise(*w)), sign.reshape(1)))

        out, state = get_map(residual_map)(one)(residuals, white, signs)
    return out, [tree_map(lambda x, i=i: None if x is None else x[i], state) for i in range(n)]


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


def wiener_filter_posterior(
    likelihood: LikelihoodWithModel,
    position=None,
    *,
    key: Optional[torch.Generator] = None,
    n_samples: int = 0,
    residual_map="vmap",
    draw_linear_kwargs: Optional[dict] = None,
    model_is_linear: bool = True,
):
    """The exact Gaussian posterior (the Wiener filter) of a linear model,
    or of the model linearised at ``position`` (``model_is_linear=False``):
    ``(Samples, (CG info of the mean, CG infos of the samples))``.

    The mean solves ``(Rᵀ N⁻¹ R + 1) m = Rᵀ N⁻¹ d`` by ``cg`` (the host
    :func:`~.conjugate_gradient.cg` unless ``draw_linear_kwargs`` names one,
    with its ``cg_kwargs``); ``n_samples`` mirrored pairs are drawn around
    it by :func:`draw_linear_residuals` (seeds from ``key``, or the stacked
    draws ``white`` among ``draw_linear_kwargs``), mapped by
    ``residual_map``, with the rest of ``draw_linear_kwargs``.  ``position``
    defaults to zeros over the model's domain."""
    if not isinstance(likelihood, LikelihoodWithModel):
        raise TypeError("likelihood must be a LikelihoodWithModel")
    kw = dict(draw_linear_kwargs or {})
    model = likelihood.forward_model
    if position is None:
        position = position_from_numpy(
            model, {k: np.zeros(v.shape) for k, v in model.domain.items()}
        )
    data = likelihood.likelihood.data
    if model_is_linear:
        forward_lin = model
    else:
        def forward_lin(t):
            return torch.func.jvp(model, (position,), (t,))[1]

        data = data - model(position) + forward_lin(position)
    _, fwd_T = torch.func.vjp(forward_lin, position)
    n_inv = partial(likelihood.likelihood.metric, model(position))
    (j,) = fwd_T(n_inv(data))

    def post_cov_inv(tangents):
        return tree_add(fwd_T(n_inv(forward_lin(tangents)))[0], tangents)

    cg = kw.pop("cg", conjugate_gradient.cg)
    res = cg(post_cov_inv, j, **kw.pop("cg_kwargs", {}))
    post_mean = res.x
    if n_samples > 0:
        keys = None if "white" in kw else seeds(key, n_samples)
        smpls, smpls_info = draw_linear_residuals(
            likelihood, post_mean, keys, residual_map=residual_map, **kw
        )
        samples = Samples(
            pos=post_mean,
            samples=concatenate_zip(smpls, tree_map(torch.neg, smpls)),
            keys=keys,
        )
    else:
        samples, smpls_info = Samples(pos=post_mean), None
    return samples, (res.info, smpls_info)
