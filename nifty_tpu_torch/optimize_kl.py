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
batch of samples, not once per sample.  ``"lmap"`` maps them by a loop,
``"pmap"`` over the ranks of the process group.
Schedules (``n_samples``, ``sample_mode``, the keyword dicts, ...) may be
callables of the iteration number.

Randomness comes from one :class:`torch.Generator` (the ``key`` of
:func:`optimize_kl` and :meth:`OptimizeVI.init_state`): each resampling
takes one integer seed a sample pair from it.  With ``odir``, every
iteration appends its status to ``odir/minisanity.txt``, pickles the
samples and the state to ``odir/last.pkl`` (their tensors on the CPU, by
:mod:`.io`, so a checkpoint of the card loads without one), from which
``resume`` goes on, plots the energy and reduced-χ² histories (when
matplotlib is there) and writes each ``export_operators`` entry's
posterior mean and standard deviation to
``odir/operator_outputs/<name>_last.npz``.

Parallel runs (``torch.distributed``, one rank a card; see
:mod:`.parallel`): ``devices=`` (a sample mesh, or a list of ranks) gives
each rank its share of the sample pairs (``host_local_slice`` of the
keys, which every rank draws alike, so each pair has the seed of the
one-process run); the KL's mean over the samples is a sum over the ranks.
``position_sharding=`` (``model.position_sharding()`` of a field
finalized with ``field_mesh=``) runs the whole loop on the rank's rows of
the field: the tree algebra and the energies sum over the field axis
inside :func:`~.parallel.collectives.field_sharded`; a mesh with a
``"samples"`` axis beside the field's shares the samples over it too.
That takes a likelihood whose data are the field's rows (each data
leaf's leading axis the rank's rows of ξ); one whose response mixes rows
(LOS, NUFFT, a sum or a cut of the field) is refused at the first
position the run sees (ROADMAP.md §A.2).  The samples and positions are the rank's shards (:meth:`OptimizeVI.gather`
puts them together); the status message reads them gathered.

:class:`OptimizeVI` takes the JAX package's hooks: ``kl_reduce`` (the
reduction over the sample axis, the mean by default), and functions in
place of the KL's value and gradient, its metric, the two samplers and
the status message.  A sampler given so draws one residual and is
called once a sample (it reads the host and draws random numbers, which
``torch.func.vmap`` refuses).
"""

from __future__ import annotations

import functools
import inspect
import os
from functools import partial
from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch

from . import io, optimize
from .evi import (
    Samples,
    concatenate_zip,
    draw_linear_residuals,
    nonlinearly_update_residuals,
    seeds,
)
from .likelihood import Likelihood, StandardHamiltonian, frozen_keys
from .logger import logger
from .minisanity import minisanity, reduced_residual_stats
from .profiling import device_of
from .parallel import collectives
from .parallel.fft import mesh_axis
from .utils.tree import ShapeWithDtype, get_map, stack, tree_map

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


def _kl_vg(likelihood, primals, primals_samples, *, map="vmap", reduce=_mean):
    """The sample-averaged (``reduce``) Hamiltonian and its gradient at
    ``primals``."""
    vg = optimize.value_and_grad(StandardHamiltonian(likelihood))
    if len(primals_samples) == 0:
        return vg(primals)
    return reduce(get_map(map)(vg)(primals_samples.at(primals).samples))


def _kl_met(likelihood, primals, tangents, primals_samples, *, map="vmap", reduce=_mean):
    """The sample-averaged (``reduce``) Hamiltonian metric applied to
    ``tangents``."""
    ham = StandardHamiltonian(likelihood)
    if len(primals_samples) == 0:
        return ham.metric(primals, tangents)
    met = get_map(map)(ham.metric, in_axes=(0, None))
    return reduce(met(primals_samples.at(primals).samples, tangents))


def _in_field(method):
    """``method`` run inside its :class:`OptimizeVI`'s field context."""

    @functools.wraps(method)
    def run(self, *args, **kwargs):
        return self._sharded(partial(method, self))(*args, **kwargs)

    return run


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


def _sample_mean(forest, axis):
    """The mean over every rank's samples of ``forest`` (this rank's
    samples on its leading axis)."""
    from .parallel.collectives import _all_reduce

    leaf = torch.utils._pytree.tree_leaves(forest)[0]
    n = _all_reduce(torch.tensor(float(leaf.shape[0]), dtype=torch.float64, device=leaf.device),
                    axis.group)
    return tree_map(lambda x: (_all_reduce(x.sum(dim=0), axis.group) / n).to(x.dtype), forest)


def _gather(forest, field=None, samples=None, keys=None):
    """The whole of a forest of this rank's shards: the row shards (the
    leaves under ``keys``; every leaf when ``keys`` is None) gathered over
    the field group ``field`` along the axis after the samples', the
    samples over ``samples`` (a ``parallel.fft.MeshAxis``) along the leading
    axis."""
    from .parallel.mesh import gather_axis

    if field is not None:
        if keys is None:
            forest = tree_map(lambda x: gather_axis(x, 1, field), forest)
        else:
            forest = {k: gather_axis(v, 1, field) if k in keys else v for k, v in forest.items()}
    if samples is not None:
        forest = tree_map(lambda x: gather_axis(x, 0, samples.group), forest)
    return forest


def get_status_message(samples, state, residual=None, *, name="", map="vmap") -> str:
    """The iteration's energy, sampling and minimisation steps, and the
    reduced χ² of the likelihood's residuals and the latent position."""
    mini_res = "" if residual is None else minisanity(samples, residual, map=map)[1]
    return _status_text(state, mini_res, minisanity(samples, map=map)[1], name)


def _status_text(state, mini_res, mini_pr, name):
    msg_smpl = ""
    st = state.sample_state
    if isinstance(st, (list, tuple)) and st and isinstance(st[0], optimize.OptimizeResults):
        msg_smpl = f"\n{name}: #(nonlinear sampling steps) {tuple(int(s.nit) for s in st)}"
    elif isinstance(st, torch.Tensor):
        msg_smpl = f"\n{name}: linear sampling status {tuple(st.reshape(-1).tolist())}"
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
        kl_reduce: Callable = _mean,
        mirror_samples: bool = True,
        devices=None,
        position_sharding=None,
        _kl_value_and_grad: Optional[Callable] = None,
        _kl_metric: Optional[Callable] = None,
        _draw_linear_residual: Optional[Callable] = None,
        _nonlinearly_update_residual: Optional[Callable] = None,
        _get_status_message: Optional[Callable] = None,
    ):
        if not mirror_samples:
            raise NotImplementedError("unmirrored samples are not supported")
        get_map(kl_map), get_map(residual_map)  # raise here for an unknown map
        self.field, self.field_keys, self.samples_axis = None, frozenset(), None
        self._row_axes, self._rows_checked = (), False
        if position_sharding is not None:
            if devices is not None:
                raise NotImplementedError(
                    "pass a single mesh with both axes via position_sharding"
                    " (a 'samples' mesh axis is picked up automatically)"
                    " instead of combining devices= with position_sharding="
                )
            split = {k: sh for k, sh in position_sharding.items() if sh.split_axes()}
            mesh = next(iter(position_sharding.values())).mesh
            (field_name,) = {a for sh in split.values() for _, a in sh.split_axes()}
            self.field = mesh.get_group(field_name)
            self.field_keys = frozenset(split)
            self._row_axes = tuple((k, i) for k, sh in split.items() for i, _ in sh.split_axes())
            if "samples" in mesh.mesh_dim_names:
                self.samples_axis = mesh_axis(mesh, "samples")
        if devices is not None:
            from torch.distributed.device_mesh import DeviceMesh

            from .parallel.mesh import sample_mesh

            mesh = devices if isinstance(devices, DeviceMesh) else sample_mesh(devices)
            self.samples_axis = mesh_axis(mesh, mesh.mesh_dim_names[0])
        if self.samples_axis is not None:
            if kl_reduce is not _mean:
                raise NotImplementedError("a kl_reduce of its own with samples across ranks")
            kl_reduce = partial(_sample_mean, axis=self.samples_axis)
        self.likelihood = likelihood
        self.residual_map = residual_map
        self.n_total_iterations = n_total_iterations
        self.kl_value_and_grad = self._sharded(_kl_value_and_grad or partial(
            _kl_vg, likelihood, map=kl_map, reduce=kl_reduce))
        self.kl_metric = self._sharded(
            _kl_metric or partial(_kl_met, likelihood, map=kl_map, reduce=kl_reduce))
        self.draw_linear_residual = _draw_linear_residual
        self.nonlinearly_update_residual = _nonlinearly_update_residual
        self.get_status_message = _get_status_message or partial(
            self._status_message, residual=likelihood.normalized_residual,
            name=type(self).__name__)

    def _sharded(self, fn):
        """``fn`` run inside this run's field context (``fn`` itself
        without one)."""
        if self.field is None:
            return fn

        def run(*args, **kwargs):
            if args:
                self._check_rows(args[0])
            with collectives.field_sharded(self.field, self.field_keys):
                return fn(*args, **kwargs)

        return run

    def _check_rows(self, pos):
        """Refuse, at the first position (or :class:`Samples`) it sees, a
        likelihood whose data are not the field's rows: a field-sharded run
        sums the energies over the field group and keeps the rank's rows
        of the data-space noise, which is right only where every data
        leaf's leading axis is the rank's rows of ξ."""
        if self._rows_checked or not self._row_axes:
            return
        pos = pos.pos if isinstance(pos, Samples) else pos
        pos = getattr(pos, "tree", pos)  # a Vector
        rows = {pos[k].shape[i] for k, i in self._row_axes if k in pos}
        if not rows:
            return
        data = torch.utils._pytree.tree_leaves(
            self.likelihood.lsm_tangents_shape, is_leaf=lambda x: isinstance(x, ShapeWithDtype))
        lead = {d.shape[0] if len(d.shape) else None for d in data}
        if len(rows) != 1 or lead != rows:
            raise NotImplementedError(
                f"position_sharding= takes a likelihood whose data are the field's rows: each"
                f" data leaf's leading axis the rank's {sorted(rows)} rows of the field, not"
                f" {sorted(lead, key=str)}; a response that mixes rows (LOS, NUFFT, a sum or a"
                " cut of the field) is not ported (ROADMAP.md §A.2)")
        self._rows_checked = True

    def gather(self, samples):
        """The :class:`Samples` of every rank, whole: the position's row
        shards joined and the residuals of every rank's samples (a
        collective: every rank calls it)."""
        if self.field is None and self.samples_axis is None:
            return samples
        pos = samples.pos
        if self.field is not None:
            pos = {k: v.unsqueeze(0) for k, v in pos.items()}
            pos = {k: v[0] for k, v in _gather(pos, self.field, None, self.field_keys).items()}
        res = samples._samples
        if res is not None:
            res = _gather(res, self.field, self.samples_axis, self.field_keys)
        keys = samples.keys
        if self.samples_axis is not None and keys is not None:
            import torch.distributed as dist

            parts = [None] * self.samples_axis.size
            dist.all_gather_object(parts, list(keys), group=self.samples_axis.group)
            keys = [k for part in parts for k in part]
        return Samples(pos=pos, samples=res, keys=keys)

    def _status_message(self, samples, state, residual=None, *, name="", map="vmap"):
        """:func:`get_status_message`; in a parallel run the residuals are
        computed on the shards and the reduced χ² read from them gathered."""
        if self.field is None and self.samples_axis is None:
            return get_status_message(samples, state, residual, name=name, map=map)
        forest = samples.samples if len(samples) else tree_map(
            lambda x: x.unsqueeze(0), samples.pos)
        mini_res = ""
        if residual is not None:
            with collectives.field_sharded(self.field, self.field_keys):
                res = get_map(map)(residual)(forest)
            res = _gather(res, self.field, self.samples_axis)
            mini_res = minisanity(Samples(samples=res))[1]
        prior = _gather(forest, self.field, self.samples_axis, self.field_keys)
        return _status_text(state, mini_res, minisanity(Samples(samples=prior))[1], name)

    # -- sampling -------------------------------------------------------------

    @_in_field
    def draw_linear_samples(self, primals, keys, **kwargs):
        """Mirrored MGVI residuals at ``primals``, one pair per key, mapped
        by ``residual_map`` (a sampler hook: called once a key):
        ``(Samples, CG infos)``."""
        if self.draw_linear_residual is None:
            residuals, infos = draw_linear_residuals(
                self.likelihood, primals, keys, residual_map=self.residual_map, **kwargs
            )
        else:
            outs = [self.draw_linear_residual(self.likelihood, primals, k, **kwargs) for k in keys]
            residuals = stack([r for r, _ in outs])
            infos = torch.stack([torch.as_tensor(i) for _, i in outs])
        smpls = concatenate_zip(residuals, tree_map(torch.neg, residuals))
        return Samples(pos=primals, samples=smpls, keys=list(keys)), infos

    @_in_field
    def nonlinearly_update_samples(self, samples: Samples, **kwargs):
        """geoVI-curve every residual of mirrored ``samples``, mapped by
        ``residual_map``: ``(Samples, the minimisers' results)``."""
        if len(samples.keys) != len(samples) // 2:
            raise ValueError("nonlinear updates need one key per mirrored pair")
        keys = [k for k in samples.keys for _ in (0, 1)]
        signs = [1.0, -1.0] * len(samples.keys)
        if self.nonlinearly_update_residual is None:
            smpls, states = nonlinearly_update_residuals(
                self.likelihood, samples.pos, samples._samples, keys, signs,
                residual_map=self.residual_map, **kwargs,
            )
        else:
            outs = [
                self.nonlinearly_update_residual(
                    self.likelihood, samples.pos, tree_map(lambda s, i=i: s[i], samples._samples),
                    k, sign, **kwargs)
                for i, (k, sign) in enumerate(zip(keys, signs))
            ]
            smpls, states = stack([r for r, _ in outs]), [st for _, st in outs]
        return Samples(pos=samples.pos, samples=smpls, keys=samples.keys), states

    @_in_field
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
        if mode.endswith("_resample") and self.samples_axis is not None:
            from .parallel.multihost import host_local_slice

            ax = self.samples_axis
            if n_samples < ax.size:
                raise ValueError(f"{n_samples} sample pairs over {ax.size} ranks leave a rank none")
            lo, hi = host_local_slice(n_samples, count=ax.size, index=ax.rank)
            keys = keys[lo:hi]
        samples, st = self.draw_linear_samples(
            samples.pos, keys, point_estimates=point_estimates, **(draw_linear_kwargs or {})
        )
        if mode.startswith("nonlinear"):
            samples, st = curve(samples)
        return samples, st

    # -- the KL -----------------------------------------------------------------

    @_in_field
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

    @_in_field
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


def _plot_history(path, nits, series, *, ylabel, logy=False):
    """A line chart of ``series`` (label -> a value an iteration) over
    ``nits``; nothing without matplotlib."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return
    fig, ax = plt.subplots(figsize=(7, 4.2), dpi=120)
    for label, vals in series.items():
        ax.plot(nits, vals, marker="o", markersize=3, linewidth=1.2, label=label)
    if logy:
        ax.set_yscale("log")
    ax.set_xlabel("iteration")
    ax.set_ylabel(ylabel)
    ax.grid(True, alpha=0.25)
    if len(series) > 1 or next(iter(series), "") != ylabel:
        ax.legend(fontsize=8, frameon=False)
    fig.tight_layout()
    fig.savefig(path)
    plt.close(fig)


def _export_history(odir, history):
    """``energy_history.png`` and the reduced-χ² histories of the
    likelihood's and the prior's residuals (``minisanity_history.png``,
    ``minisanity_prior_history.png``) in ``odir``."""
    nits = history["nit"]
    if not nits:
        return
    e = np.asarray(history["energy"], dtype=float)
    logy = bool(np.all(e > 0) and e.max() / max(e.min(), 1e-30) > 1e3)
    _plot_history(os.path.join(odir, "energy_history.png"), nits, {"KL energy": e},
                  ylabel="KL energy", logy=logy)
    for slot, fname, what in (("lh_chisq", "minisanity_history.png", "likelihood"),
                              ("prior_chisq", "minisanity_prior_history.png", "prior")):
        if history[slot]:
            _plot_history(os.path.join(odir, fname), nits, history[slot],
                          ylabel=f"reduced chi² ({what} residuals)", logy=True)


def _chisq_series(stats, prefix):
    """``(name, reduced χ²)`` of every :class:`~.minisanity.ChiSqStats` in
    ``stats`` (its mean over the samples), named by its path."""
    if hasattr(stats, "reduced_chisq"):
        yield prefix, float(stats.reduced_chisq.reshape(-1)[0])
    elif isinstance(stats, dict):
        for k, v in stats.items():
            yield from _chisq_series(v, f"{prefix}/{k}" if prefix else str(k))
    elif isinstance(stats, (list, tuple)):
        for j, v in enumerate(stats):
            yield from _chisq_series(v, f"{prefix}[{j}]")


def _record_history(history, samples, state, likelihood):
    history["nit"].append(state.nit)
    history["energy"].append(float(state.minimization_state.fun))
    try:
        lh_stats = reduced_residual_stats(samples, likelihood.normalized_residual)
    except NotImplementedError:  # a likelihood without normalized residuals
        lh_stats = None
    for slot, stats, label in (("lh_chisq", lh_stats, "lh"),
                               ("prior_chisq", reduced_residual_stats(samples), "prior")):
        if stats is not None:
            for name, val in _chisq_series(stats, ""):
                history[slot].setdefault(name or label, []).append(val)


def _export_operator_outputs(odir, export_operators, samples, nit):
    """Each operator's posterior mean and standard deviation (``ddof`` 0)
    over ``samples``, ``odir/operator_outputs/<name>_last.npz``."""
    opdir = os.path.join(odir, "operator_outputs")
    os.makedirs(opdir, exist_ok=True)
    with torch.no_grad():
        for name, op in export_operators.items():
            vals = torch.stack([op(s) for s in samples])
            np.savez(os.path.join(opdir, f"{name}_last.npz"),
                     mean=vals.mean(dim=0).cpu().numpy(),
                     std=vals.std(dim=0, correction=0).cpu().numpy(), nit=nit)


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
    kl_reduce: Callable = _mean,
    mirror_samples: bool = True,
    draw_linear_kwargs=None,
    nonlinearly_update_kwargs=None,
    kl_kwargs=None,
    sample_mode="nonlinear_resample",
    resume=False,
    callback: Optional[Callable] = None,
    odir: Optional[str] = None,
    export_operators: Optional[dict] = None,
    devices=None,
    position_sharding=None,
    _optimize_vi: Optional[OptimizeVI] = None,
    _optimize_vi_state: Optional[OptimizeVIState] = None,
):
    """MGVI/geoVI from a position (or samples): ``n_total_iterations`` of
    :meth:`OptimizeVI.update`; returns the samples and the state.
    ``resume`` (True, or the path of a checkpoint) goes on from
    ``odir/last.pkl`` when it exists; ``callback(samples, state)`` runs
    after each iteration.  With ``odir``, ``export_operators`` (name -> a
    function of one sample) are written as their posterior mean and
    standard deviation each iteration.  ``_optimize_vi`` and
    ``_optimize_vi_state`` replace the :class:`OptimizeVI` and the state
    this function would make.  ``devices`` and ``position_sharding`` run
    it across ranks (see the module's docstring; the position is the
    rank's shards, as ``position_from_numpy(..., sharding=)`` gives it);
    ``odir`` is not taken with them."""
    opt_vi = _optimize_vi or OptimizeVI(
        likelihood,
        n_total_iterations,
        kl_map=kl_map,
        residual_map=residual_map,
        kl_reduce=kl_reduce,
        mirror_samples=mirror_samples,
        devices=devices,
        position_sharding=position_sharding,
    )
    if odir is not None and (opt_vi.field is not None or opt_vi.samples_axis is not None):
        raise NotImplementedError("odir with devices= or position_sharding= is not ported "
                                  "(ROADMAP.md): gather the samples (OptimizeVI.gather) and save them")
    last_fn = os.path.join(odir, "last.pkl") if odir is not None else None
    resume_fn = resume if isinstance(resume, str) and os.path.isfile(resume) else last_fn
    sanity_fn = os.path.join(odir, "minisanity.txt") if odir is not None else None

    samples = position_or_samples
    if not isinstance(samples, Samples):
        samples = Samples(pos=position_or_samples)
    state = None
    if resume and resume_fn is not None and os.path.isfile(resume_fn):
        samples, state = io.load(resume_fn, device_of(samples.pos))
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
    state = _optimize_vi_state or state or fresh
    if not state.config:  # a pickled state leaves its schedule behind
        state = state._replace(config=fresh.config)

    if odir:
        os.makedirs(odir, exist_ok=True)
        if not resume:
            open(sanity_fn, "w").close()
    history = {"nit": [], "energy": [], "lh_chisq": {}, "prior_chisq": {}}
    for i in range(state.nit, opt_vi.n_total_iterations):
        logger.info(f"OPTIMIZE_KL: Starting {i + 1:04d}")
        samples, state = opt_vi.update(samples, state)
        msg = opt_vi.get_status_message(samples, state, name="OPTIMIZE_KL")
        logger.info(msg)
        if odir:
            with open(sanity_fn, "a") as f:
                f.write("\n" + msg)
            _record_history(history, samples, state, opt_vi.likelihood)
            _export_history(odir, history)
            if export_operators:
                _export_operator_outputs(odir, export_operators, samples, state.nit)
            io.dump((samples, state._replace(config={})), last_fn)
        if callback is not None:
            callback(samples, state)
    return samples, state
