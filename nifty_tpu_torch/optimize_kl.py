"""The MGVI/geoVI loop (counterpart of ``nifty_tpu/optimize_kl.py``).

Each iteration of :class:`OptimizeVI` (``update``) does two things:

1. samples: draw mirrored MGVI residuals at the current position (CG over
   the Hamiltonian metric), optionally curve them by geoVI, or curve the
   previous ones again, as the iteration's ``sample_mode`` says;
2. the KL: minimise the sample-averaged Hamiltonian over the position by
   Newton-CG, the samples' residuals held fixed.

The samples are mapped as one batch (``kl_map`` and ``residual_map``
``"vmap"``, the defaults, as in the JAX package): the KL's value, gradient
and metric through ``torch.func.vmap``, the samplers on an explicit sample
axis (``evi.draw_linear_residuals``), so each kernel (K1-K4) runs once per
batch of samples, not once per sample.  ``"lmap"`` maps them by a loop;
sharding over cards (``"pmap"``) is not ported (ROADMAP.md, section A).
Schedules (``n_samples``, ``sample_mode``, the keyword dicts, ...) may be
callables of the iteration number.

Randomness comes from one :class:`torch.Generator` (the ``key`` of
:func:`optimize_kl` and :meth:`OptimizeVI.init_state`): each resampling
takes one integer seed a sample pair from it.  With ``odir``, every
iteration appends its status to ``odir/minisanity.txt`` and pickles the
samples and the state to ``odir/last.pkl``, from which ``resume`` goes on.
"""

from __future__ import annotations

import inspect
import os
import pickle
from functools import partial
from typing import Any, Callable, NamedTuple, Optional

import torch

from . import optimize
from .evi import (
    Samples,
    concatenate_zip,
    draw_linear_residuals,
    nonlinearly_update_residuals,
    seeds,
)
from .likelihood import Likelihood, StandardHamiltonian, frozen_keys
from .logger import logger
from .minisanity import minisanity
from .utils.tree import get_map, tree_map

__all__ = ["OptimizeVI", "OptimizeVIState", "get_status_message", "optimize_kl"]

SAMPLE_MODES = (
    "linear_sample",
    "linear_resample",
    "nonlinear_sample",
    "nonlinear_resample",
    "nonlinear_update",
)


def _mean(forest):
    """Mean over the leading (sample) axis of every leaf."""
    return tree_map(lambda x: x.mean(dim=0), forest)


def _kl_vg(likelihood, primals, primals_samples, *, map="vmap"):
    """The sample-averaged Hamiltonian and its gradient at ``primals``."""
    vg = optimize.value_and_grad(StandardHamiltonian(likelihood))
    if len(primals_samples) == 0:
        return vg(primals)
    return _mean(get_map(map)(vg)(primals_samples.at(primals).samples))


def _kl_met(likelihood, primals, tangents, primals_samples, *, map="vmap"):
    """The sample-averaged Hamiltonian metric applied to ``tangents``."""
    ham = StandardHamiltonian(likelihood)
    if len(primals_samples) == 0:
        return ham.metric(primals, tangents)
    met = get_map(map)(ham.metric, in_axes=(0, None))
    return _mean(met(primals_samples.at(primals).samples, tangents))


class OptimizeVIState(NamedTuple):
    nit: int
    key: Any  # the torch.Generator the samples' seeds come from
    sample_state: Optional[Any] = None
    minimization_state: Optional[Any] = None
    config: dict = {}


def _getitem_at_nit(config, key, nit):
    """``config[key]``, called with ``nit`` when it is a function of one
    argument (a schedule)."""
    c = config[key]
    if callable(c) and len(inspect.getfullargspec(c).args) == 1:
        return c(nit)
    return c


def _sample_mode(mode: str, n_samples: int, n_keys: int) -> str:
    """The mode an iteration runs: "" without samples; a fresh draw
    (``*_resample``) where the number of samples changed."""
    mode = mode.lower()
    if mode not in SAMPLE_MODES:
        raise ValueError(f"invalid sample mode {mode!r}")
    if n_samples == 0:
        return ""
    if n_samples != n_keys:
        return "nonlinear_resample" if mode == "nonlinear_update" else mode.replace("_sample", "_resample")
    return mode


def get_status_message(samples, state, residual=None, *, name="", map="vmap") -> str:
    """The iteration's energy, sampling and minimisation steps, and the
    reduced χ² of the likelihood's residuals and the latent position."""
    msg_smpl = ""
    st = state.sample_state
    if isinstance(st, (list, tuple)) and st and isinstance(st[0], optimize.OptimizeResults):
        msg_smpl = f"\n{name}: #(nonlinear sampling steps) {tuple(int(s.nit) for s in st)}"
    elif isinstance(st, torch.Tensor):
        msg_smpl = f"\n{name}: linear sampling status {tuple(st.reshape(-1).tolist())}"
    mini_res = "" if residual is None else minisanity(samples, residual, map=map)[1]
    mini_pr = minisanity(samples, map=map)[1]
    return (
        f"{name}: Iteration {state.nit:04d} E:{float(state.minimization_state.fun):+2.4e}"
        f"{msg_smpl}"
        f"\n{name}: #(KL minimization steps) {int(state.minimization_state.nit)}"
        f"\n{name}: Likelihood residual(s):\n{mini_res}"
        f"\n{name}: Prior residual(s):\n{mini_pr}\n"
    )


class OptimizeVI:
    """The MGVI/geoVI update for one likelihood: sampling, KL minimisation
    and the iteration that joins them.  It keeps no state between calls:
    :meth:`update` takes and returns the samples and an
    :class:`OptimizeVIState`."""

    def __init__(
        self,
        likelihood: Likelihood,
        n_total_iterations: int,
        *,
        kl_map="vmap",
        residual_map="vmap",
        mirror_samples: bool = True,
    ):
        if not mirror_samples:
            raise NotImplementedError("unmirrored samples are not supported")
        get_map(kl_map), get_map(residual_map)  # raise here for a map that is not ported
        self.likelihood = likelihood
        self.residual_map = residual_map
        self.n_total_iterations = n_total_iterations
        self.kl_value_and_grad = partial(_kl_vg, likelihood, map=kl_map)
        self.kl_metric = partial(_kl_met, likelihood, map=kl_map)
        self.get_status_message = partial(
            get_status_message, residual=likelihood.normalized_residual, name=type(self).__name__
        )

    # -- sampling -------------------------------------------------------------

    def draw_linear_samples(self, primals, keys, **kwargs):
        """Mirrored MGVI residuals at ``primals``, one pair per key, mapped
        by ``residual_map``: ``(Samples, CG infos)``."""
        residuals, infos = draw_linear_residuals(
            self.likelihood, primals, keys, residual_map=self.residual_map, **kwargs
        )
        smpls = concatenate_zip(residuals, tree_map(torch.neg, residuals))
        return Samples(pos=primals, samples=smpls, keys=list(keys)), infos

    def nonlinearly_update_samples(self, samples: Samples, **kwargs):
        """geoVI-curve every residual of mirrored ``samples``, mapped by
        ``residual_map``: ``(Samples, the minimisers' results)``."""
        if len(samples.keys) != len(samples) // 2:
            raise ValueError("nonlinear updates need one key per mirrored pair")
        keys = [k for k in samples.keys for _ in (0, 1)]
        signs = [1.0, -1.0] * len(samples.keys)
        smpls, states = nonlinearly_update_residuals(
            self.likelihood, samples.pos, samples._samples, keys, signs,
            residual_map=self.residual_map, **kwargs,
        )
        return Samples(pos=samples.pos, samples=smpls, keys=samples.keys), states

    def draw_samples(
        self,
        samples: Samples,
        *,
        key: torch.Generator,
        sample_mode: str,
        n_samples: int,
        point_estimates,
        draw_linear_kwargs=None,
        nonlinearly_update_kwargs=None,
    ):
        """The samples of an iteration, as ``sample_mode`` says, and their
        state (CG infos, the geoVI minimisers' results, or 0 without
        samples)."""
        n_keys = 0 if samples.keys is None else len(samples.keys)
        mode = _sample_mode(sample_mode, n_samples, n_keys)
        if mode == "":
            return samples, 0
        curve = partial(
            self.nonlinearly_update_samples,
            point_estimates=point_estimates,
            **(nonlinearly_update_kwargs or {}),
        )
        if mode == "nonlinear_update":
            return curve(samples)
        keys = seeds(key, n_samples) if mode.endswith("_resample") else samples.keys
        samples, st = self.draw_linear_samples(
            samples.pos, keys, point_estimates=point_estimates, **(draw_linear_kwargs or {})
        )
        if mode.startswith("nonlinear"):
            samples, st = curve(samples)
        return samples, st

    # -- the KL -----------------------------------------------------------------

    def kl_minimize(
        self,
        samples: Samples,
        minimize: Callable = optimize.newton_cg,
        minimize_kwargs=None,
        constants=(),
    ) -> optimize.OptimizeResults:
        """Minimise the sample-averaged KL over the position, the keys in
        ``constants`` held at their values."""
        vg = partial(self.kl_value_and_grad, primals_samples=samples)
        met = partial(self.kl_metric, primals_samples=samples)
        frozen = {k: v for k, v in samples.pos.items() if k in frozen_keys(constants)}
        if not frozen:
            return minimize(None, x0=samples.pos, fun_and_grad=vg, hessp=met, **(minimize_kwargs or {}))

        def liquid(tree):
            return {k: v for k, v in tree.items() if k not in frozen}

        def fun_and_grad(x):
            v, g = vg({**x, **frozen})
            return v, liquid(g)

        def hessp(x, t):
            zeros = {k: torch.zeros_like(v) for k, v in frozen.items()}
            return liquid(met({**x, **frozen}, {**t, **zeros}))

        res = minimize(
            None, x0=liquid(samples.pos), fun_and_grad=fun_and_grad, hessp=hessp,
            **(minimize_kwargs or {}),
        )
        return res._replace(x={**res.x, **frozen}, jac={**res.jac, **frozen})

    # -- the iteration ------------------------------------------------------------

    def init_state(
        self,
        key: torch.Generator,
        *,
        nit: int = 0,
        n_samples,
        draw_linear_kwargs=None,
        nonlinearly_update_kwargs=None,
        kl_kwargs=None,
        sample_mode="nonlinear_resample",
        point_estimates=(),
        constants=(),
    ) -> OptimizeVIState:
        config = dict(
            n_samples=n_samples,
            sample_mode=sample_mode,
            point_estimates=point_estimates,
            constants=constants,
            draw_linear_kwargs=draw_linear_kwargs or {},
            nonlinearly_update_kwargs=nonlinearly_update_kwargs or {},
            kl_kwargs=kl_kwargs or {},
        )
        return OptimizeVIState(nit, key, config=config)

    def update(self, samples: Samples, state: OptimizeVIState):
        """One VI iteration: the samples, then the KL step."""
        if not isinstance(samples, Samples):
            raise TypeError(f"`samples` must be Samples; got {type(samples)!r}")
        at = partial(_getitem_at_nit, state.config, nit=state.nit)
        samples, st_smpls = self.draw_samples(
            samples,
            key=state.key,
            sample_mode=at(key="sample_mode"),
            n_samples=at(key="n_samples"),
            point_estimates=at(key="point_estimates"),
            draw_linear_kwargs=at(key="draw_linear_kwargs"),
            nonlinearly_update_kwargs=at(key="nonlinearly_update_kwargs"),
        )
        kl_state = self.kl_minimize(samples, constants=at(key="constants"), **at(key="kl_kwargs"))
        samples = samples.at(kl_state.x)
        kl_state = kl_state._replace(x=None, jac=None, hess=None, hess_inv=None)
        return samples, state._replace(
            nit=state.nit + 1, sample_state=st_smpls, minimization_state=kl_state
        )

    def run(self, samples, *args, **kwargs):
        """``n_total_iterations`` updates from :meth:`init_state` (``*args``,
        ``**kwargs``)."""
        state = self.init_state(*args, **kwargs)
        for i in range(state.nit, self.n_total_iterations):
            logger.info(f"{type(self).__name__}: Starting {i + 1:04d}")
            samples, state = self.update(samples, state)
            logger.info(self.get_status_message(samples, state))
        return samples, state


def optimize_kl(
    likelihood: Likelihood,
    position_or_samples,
    *,
    key: torch.Generator,
    n_total_iterations: int,
    n_samples,
    point_estimates=(),
    constants=(),
    kl_map="vmap",
    residual_map="vmap",
    mirror_samples: bool = True,
    draw_linear_kwargs=None,
    nonlinearly_update_kwargs=None,
    kl_kwargs=None,
    sample_mode="nonlinear_resample",
    resume=False,
    callback: Optional[Callable] = None,
    odir: Optional[str] = None,
):
    """MGVI/geoVI from a position (or samples): ``n_total_iterations`` of
    :meth:`OptimizeVI.update`; returns the samples and the state.
    ``resume`` (True, or the path of a pickle) goes on from ``odir/last.pkl``
    when it exists; ``callback(samples, state)`` runs after each
    iteration."""
    opt_vi = OptimizeVI(
        likelihood,
        n_total_iterations,
        kl_map=kl_map,
        residual_map=residual_map,
        mirror_samples=mirror_samples,
    )
    last_fn = os.path.join(odir, "last.pkl") if odir is not None else None
    resume_fn = resume if isinstance(resume, str) and os.path.isfile(resume) else last_fn
    sanity_fn = os.path.join(odir, "minisanity.txt") if odir is not None else None

    samples = position_or_samples
    if not isinstance(samples, Samples):
        samples = Samples(pos=position_or_samples)
    state = None
    if resume and resume_fn is not None and os.path.isfile(resume_fn):
        with open(resume_fn, "rb") as f:  # written by this function
            samples, state = pickle.load(f)
    fresh = opt_vi.init_state(
        key,
        n_samples=n_samples,
        draw_linear_kwargs=draw_linear_kwargs,
        nonlinearly_update_kwargs=nonlinearly_update_kwargs,
        kl_kwargs=kl_kwargs,
        sample_mode=sample_mode,
        point_estimates=point_estimates,
        constants=constants,
    )
    state = fresh if state is None else state
    if not state.config:  # a pickled state leaves its schedule behind
        state = state._replace(config=fresh.config)

    if odir:
        os.makedirs(odir, exist_ok=True)
        if not resume:
            open(sanity_fn, "w").close()
    for i in range(state.nit, opt_vi.n_total_iterations):
        logger.info(f"OPTIMIZE_KL: Starting {i + 1:04d}")
        samples, state = opt_vi.update(samples, state)
        msg = opt_vi.get_status_message(samples, state, name="OPTIMIZE_KL")
        logger.info(msg)
        if sanity_fn is not None:
            with open(sanity_fn, "a") as f:
                f.write("\n" + msg)
        if last_fn is not None:
            with open(last_fn, "wb") as f:
                pickle.dump((samples, state._replace(config={})), f)
        if callback is not None:
            callback(samples, state)
    return samples, state
