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
Each data leaf is split along its leading axis: it is either the rank's
rows of the field, or the rank's share of the output of a response of
them (``ExactGridLOS``, ``SamplingCartesianGridLOS``, the NUFFT with fixed
or learned coordinates, ``ShiftedPositionFFT``, SKI's ``interp_mat``, the
dynamics priors), which sums or exchanges the ranks' partial outputs and
keeps the rank's block of them: ``np.array_split``'s blocks, so the first
``M mod p`` ranks hold one point more.  Any other likelihood (a response
that mixes rows otherwise: a sum or a cut of the field, ``ToeplitzSKI``;
replicated data) is refused at the first position the run sees
(ROADMAP.md).  The samples and positions are the rank's shards
(:meth:`OptimizeVI.gather` puts them together, :meth:`OptimizeVI.scatter`
cuts them); the status message reads them gathered.  With
``odir`` the mesh's first rank writes the files of the one-process run,
from the gathered samples, and a resume cuts the loaded ones again; each
exported operator runs on the shards and its output is gathered along
its leading axis where a field or a field-aware response returned it.  A
mesh may hold some of the ranks only (two fits side by side on disjoint
cards; every rank builds every mesh, in one order): its collectives,
barriers and files involve its own ranks alone.

:class:`OptimizeVI` takes the JAX package's hooks: ``kl_reduce`` (the
reduction over the sample axis, the mean by default; with samples across
ranks the default sums over them, another gathers the per-sample values
in the global sample order first), and functions in
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
from torch.utils._pytree import tree_leaves

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


class _SampleGather(torch.autograd.Function):
    """Every rank's samples of ``x`` (this rank's on the leading axis, the
    ranks' counts ``sizes``) joined in the global sample order; the adjoint
    keeps this rank's slice of the cotangent (each sample lives on one
    rank, so nothing is summed)."""

    @staticmethod
    def forward(x, group, sizes, rank):
        from .parallel.mesh import gather_axis

        return gather_axis(x, 0, group, sizes=sizes)

    @staticmethod
    def setup_context(ctx, inputs, output):
        _, ctx.group, ctx.sizes, ctx.rank = inputs

    @staticmethod
    def backward(ctx, grad):
        return grad.narrow(0, sum(ctx.sizes[: ctx.rank]), ctx.sizes[ctx.rank]), None, None, None

    @staticmethod
    def jvp(ctx, tangent, *_):
        return _SampleGather.apply(tangent, ctx.group, ctx.sizes, ctx.rank)


def _sample_reduce(forest, axis, reduce):
    """The caller's ``reduce`` (a ``kl_reduce`` of its own) of every rank's
    samples: the per-sample values gathered over the samples axis in the
    global sample order (:class:`_SampleGather`), then reduced alike on
    every rank."""
    from .parallel.mesh import gather_axis

    n = torch.utils._pytree.tree_leaves(forest)[0].shape[0]
    sizes = gather_axis(torch.tensor([n]), 0, axis.group).tolist()
    return reduce(tree_map(lambda x: _SampleGather.apply(x, axis.group, sizes, axis.rank), forest))


def _mesh_ranks(mesh):
    """``(first, barrier)`` of the ranks of ``mesh``: whether this rank is
    the mesh's first (local rank 0 on every axis), and a barrier over the
    mesh's ranks alone (one over each axis group in turn, which holds every
    rank of the mesh once they all passed), so a mesh over some of the
    ranks (two fits side by side on disjoint cards) needs no group of its
    own and leaves the other ranks out."""
    import torch.distributed as dist

    names = mesh.mesh_dim_names

    def barrier():
        for name in names:
            dist.barrier(group=mesh.get_group(name))

    return all(mesh.get_local_rank(name) == 0 for name in names), barrier


def _gather(forest, field=None, samples=None, keys=None):
    """The whole of a forest of this rank's shards: the row shards (the
    leaves under ``keys``; every leaf when ``keys`` is None) gathered over
    the field group ``field`` along the axis after the samples', the
    samples over ``samples`` (a ``parallel.fft.MeshAxis``) along the leading
    axis.  A response's shares and the ranks' sample counts may differ by
    one (``np.array_split``'s blocks, ``host_local_slice``'s)."""
    from .parallel.mesh import gather_axis

    if field is not None:
        if keys is None:
            forest = tree_map(lambda x: gather_axis(x, 1, field, uneven=True), forest)
        else:
            forest = {k: gather_axis(v, 1, field) if k in keys else v for k, v in forest.items()}
    if samples is not None:
        forest = tree_map(lambda x: gather_axis(x, 0, samples.group, uneven=True), forest)
    return forest


def _field_aware(root):
    """``(found, nufft)``: the field-aware responses (objects with a
    ``field_share`` method) that ``root`` can call, and whether it can call
    ``nufft2`` (whose share of a row-sharded field shows only when it
    runs: the function itself, code that names it, ``nt.nufft2`` too, or a
    ``VariablePositionNufft`` or ``ShiftedPositionFFT``),
    through modules, containers, partials, bound methods and functions'
    closures, defaults and the globals they name."""
    import types

    from .ops.nufft import ShiftedPositionFFT, VariablePositionNufft, nufft2

    found, nufft, seen, todo = [], False, set(), [root]
    while todo:
        obj = todo.pop()
        nufft = nufft or obj is nufft2 or isinstance(obj, (VariablePositionNufft, ShiftedPositionFFT))
        if id(obj) in seen or isinstance(obj, (torch.Tensor, np.ndarray, str, bytes, int, float,
                                               type, types.ModuleType)):
            continue
        seen.add(id(obj))
        if callable(getattr(obj, "field_share", None)):
            found.append(obj)
        if isinstance(obj, dict):
            todo.extend(obj.values())
        elif isinstance(obj, (list, tuple, set, frozenset)):
            todo.extend(obj)
        elif isinstance(obj, partial):
            todo.extend((obj.func, *obj.args, *obj.keywords.values()))
        elif isinstance(obj, types.MethodType):
            todo.extend((obj.__self__, obj.__func__))
        elif isinstance(obj, types.FunctionType):
            todo.extend(c.cell_contents for c in obj.__closure__ or () if _filled(c))
            todo.extend((obj.__defaults__ or ()) + tuple((obj.__kwdefaults__ or {}).values()))
            codes, names = [obj.__code__], set()
            while codes:
                code = codes.pop()
                names.update(code.co_names)
                codes.extend(c for c in code.co_consts if isinstance(c, types.CodeType))
            nufft = nufft or "nufft2" in names
            todo.extend(obj.__globals__[n] for n in names if n in obj.__globals__)
        elif hasattr(obj, "__dict__"):
            todo.extend(vars(obj).values())
    return found, nufft


def _filled(cell):
    try:
        cell.cell_contents
    except ValueError:  # a cell not yet bound
        return False
    return True


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
        self._row_axes, self._rows_checked, self._mesh = (), False, None
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
            self._mesh = mesh
        if devices is not None:
            from torch.distributed.device_mesh import DeviceMesh

            from .parallel.mesh import sample_mesh

            mesh = devices if isinstance(devices, DeviceMesh) else sample_mesh(devices)
            self.samples_axis = mesh_axis(mesh, mesh.mesh_dim_names[0])
            self._mesh = mesh
        if self.samples_axis is not None:
            if kl_reduce is _mean:
                kl_reduce = partial(_sample_mean, axis=self.samples_axis)
            else:
                kl_reduce = partial(_sample_reduce, axis=self.samples_axis, reduce=kl_reduce)
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
        likelihood whose data it cannot vouch for.  A field-sharded run sums
        the energies over the field group and draws the data-space noise
        of the rank's block of each data leaf's leading axis, which is right
        where each data leaf is the rank's rows of ξ, the rank's share of
        the output of a field-aware response the likelihood can call (the
        line of sight, SKI's interpolation: found in the likelihood, before
        any collective), or, where the likelihood can call ``nufft2``, the
        share that a response noted when the likelihood ran once at ``pos``
        in the field context (every rank runs it alike)."""
        if self._rows_checked or not self._row_axes:
            return
        pos = pos.pos if isinstance(pos, Samples) else pos
        pos = getattr(pos, "tree", pos)  # a Vector
        rows = {pos[k].shape[i] for k, i in self._row_axes if k in pos}
        if not rows:
            return
        data = tree_leaves(self.likelihood.lsm_tangents_shape,
                           is_leaf=lambda x: isinstance(x, ShapeWithDtype))
        shares, pending = None, []
        for d in data:
            if len(rows) == 1 and len(d.shape) and d.shape[0] in rows:
                continue
            if shares is None:
                import torch.distributed as dist

                found, nufft = _field_aware(self.likelihood)
                p, r = (dist.get_world_size(self.field), dist.get_rank(self.field)) if found else (1, 0)
                shares = {tuple(resp.field_share(p, r)) for resp in found}
            if tuple(d.shape) not in shares:
                pending.append(tuple(d.shape))
        noted = set()
        if pending and nufft:  # the NUFFT's share shows when it runs
            with torch.no_grad(), collectives.field_sharded(self.field, self.field_keys) as ctx:
                self.likelihood(pos)
                noted = set(ctx.notes) - ctx.rows
        if pending:
            bad = [s for s in pending if s not in noted]
            if bad:
                raise NotImplementedError(
                    f"position_sharding= takes a likelihood whose data are the field's rows or"
                    f" the rank's share of a response of them (ExactGridLOS,"
                    f" SamplingCartesianGridLOS, the NUFFT, SKI's interp_mat; np.array_split's"
                    f" blocks of its points): each data leaf's leading axis the rank's"
                    f" {sorted(rows)} rows of the field, or this rank's share, a leaf of shape"
                    f" {sorted(shares | noted)}, not {bad[0]}; a response that mixes rows"
                    " otherwise (a sum or a cut of the field, ToeplitzSKI) is not ported"
                    " (ROADMAP.md)")
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

    def scatter(self, samples):
        """This rank's shards of whole ``samples`` (the inverse of
        :meth:`gather`): the rows of the position's and the residuals' row
        shards, and this rank's share of the sample pairs."""
        if self.field is None and self.samples_axis is None:
            return samples
        pos, res, keys = samples.pos, samples._samples, samples.keys
        if self.field is not None:
            import torch.distributed as dist

            p, r = dist.get_world_size(self.field), dist.get_rank(self.field)
            split = dict(self._row_axes)

            def cut(x, axis):
                b = x.shape[axis] // p
                return x.narrow(axis, r * b, b).contiguous()

            pos = {k: cut(v, split[k]) if k in split else v for k, v in pos.items()}
            if res is not None:
                res = {k: cut(v, split[k] + 1) if k in split else v for k, v in res.items()}
        if self.samples_axis is not None and keys is not None:
            from .parallel.multihost import host_local_slice

            ax = self.samples_axis
            lo, hi = host_local_slice(len(keys), count=ax.size, index=ax.rank)
            keys = list(keys)[lo:hi]
            res = tree_map(lambda x: x[2 * lo : 2 * hi], res)
        return Samples(pos=pos, samples=res, keys=keys)

    def gather_state(self, state: OptimizeVIState) -> OptimizeVIState:
        """``state`` with the sample states of every rank's samples, in
        order, as the one-process run has them (a collective); a geoVI
        minimiser's result without its position and gradient, which are
        the rank's shards."""
        if self.field is None and self.samples_axis is None:
            return state
        st = state.sample_state
        if isinstance(st, (list, tuple)):
            st = [s._replace(x=None, jac=None, hess=None, hess_inv=None)
                  if isinstance(s, optimize.OptimizeResults) else s for s in st]
        if self.samples_axis is not None:
            import torch.distributed as dist

            from . import io as _io

            parts = [None] * self.samples_axis.size
            dist.all_gather_object(parts, _io.to_cpu(st), group=self.samples_axis.group)
            if isinstance(st, torch.Tensor):
                st = torch.cat(parts).to(st.device)
            elif isinstance(st, (list, tuple)):
                st = [s for part in parts for s in part]
        return state._replace(sample_state=st)

    def residual_forests(self, samples, residual=None, *, map="vmap"):
        """``(residuals, prior)``: ``residual`` (the likelihood's normalized
        residual, or None) of every sample and the samples themselves, each
        whole, with a leading sample axis (a collective in a parallel run:
        the residuals are computed on the shards and gathered)."""
        forest = samples.samples if len(samples) else tree_map(
            lambda x: x.unsqueeze(0), samples.pos)
        res = None
        if residual is not None:
            with collectives.field_sharded(self.field, self.field_keys):
                res = get_map(map)(residual)(forest)
            res = _gather(res, self.field, self.samples_axis)
        return res, _gather(forest, self.field, self.samples_axis, self.field_keys)

    def _status_message(self, samples, state, residual=None, *, name="", map="vmap"):
        """:func:`get_status_message`; in a parallel run the residuals are
        computed on the shards and the reduced χ² read from them gathered."""
        res, prior = self.residual_forests(samples, residual, map=map)
        mini_res = "" if res is None else minisanity(Samples(samples=res))[1]
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


def _residual_stats(opt_vi, samples):
    """The reduced-χ² statistics of the likelihood's residuals (None
    without normalized residuals) and of the prior's over ``samples``,
    from the gathered samples in a parallel run (a collective there)."""
    try:
        res, prior = opt_vi.residual_forests(samples, opt_vi.likelihood.normalized_residual)
    except NotImplementedError:  # a likelihood without normalized residuals
        res, prior = opt_vi.residual_forests(samples)
    lh_stats = None if res is None else reduced_residual_stats(Samples(samples=res))
    return lh_stats, reduced_residual_stats(Samples(samples=prior))


def _record_history(history, state, lh_stats, prior_stats):
    history["nit"].append(state.nit)
    history["energy"].append(float(state.minimization_state.fun))
    for slot, stats, label in (("lh_chisq", lh_stats, "lh"), ("prior_chisq", prior_stats, "prior")):
        if stats is not None:
            for name, val in _chisq_series(stats, ""):
                history[slot].setdefault(name or label, []).append(val)


def _operator_values(opt_vi, op, samples):
    """``op`` of every sample, stacked, whole (a collective in a parallel
    run: every rank calls it).  In a field-sharded run
    ``op`` runs on the rank's shards inside the field context: an output
    that a field or a field-aware response returned (the last split value
    noted, of the output's shape) is gathered along its leading axis, one
    that none returned is replicated; the samples of every rank are
    gathered after."""
    with torch.no_grad(), collectives.field_sharded(opt_vi.field, opt_vi.field_keys) as ctx:
        vals, split = [], False
        for s in samples:
            if ctx is not None:
                ctx.notes.clear()
            v = op(s)
            if ctx is not None and ctx.notes:
                split = ctx.notes[-1] == tuple(v.shape)
                if not split:
                    raise NotImplementedError(
                        f"an exported operator's output of shape {tuple(v.shape)} is neither a"
                        f" split value its model returned ({ctx.notes[-1]}) nor replicated")
            vals.append(v)
    vals = torch.stack(vals)
    return _gather(vals, opt_vi.field if split else None, opt_vi.samples_axis)


def _export_operator_outputs(odir, export_operators, samples, nit, opt_vi, write):
    """Each operator's posterior mean and standard deviation (``ddof`` 0)
    over every rank's ``samples``, ``odir/operator_outputs/<name>_last.npz``
    (written where ``write``)."""
    opdir = os.path.join(odir, "operator_outputs")
    if write:
        os.makedirs(opdir, exist_ok=True)
    for name, op in export_operators.items():
        vals = _operator_values(opt_vi, op, samples)
        if write:
            np.savez(os.path.join(opdir, f"{name}_last.npz"), mean=vals.mean(dim=0).cpu().numpy(),
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
    rank's shards, as ``position_from_numpy(..., sharding=)`` gives it):
    every rank calls it, the run's first rank writes ``odir``'s files,
    which hold the whole samples, and a resume loads them on every rank
    and cuts its shards."""
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
    across = opt_vi.field is not None or opt_vi.samples_axis is not None
    mesh = opt_vi._mesh if across and odir is not None else None
    writes, barrier = _mesh_ranks(mesh) if mesh is not None else (True, None)
    last_fn = os.path.join(odir, "last.pkl") if odir is not None else None
    resume_fn = resume if isinstance(resume, str) and os.path.isfile(resume) else last_fn
    sanity_fn = os.path.join(odir, "minisanity.txt") if odir is not None else None

    samples = position_or_samples
    if not isinstance(samples, Samples):
        samples = Samples(pos=position_or_samples)
    state = None
    if barrier is not None and resume:
        barrier()  # the first rank's last write is whole before anyone reads
    if resume and resume_fn is not None and os.path.isfile(resume_fn):
        samples, state = io.load(resume_fn, device_of(samples.pos))
        samples = opt_vi.scatter(samples)
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

    if odir and writes:
        os.makedirs(odir, exist_ok=True)
        if not resume:
            open(sanity_fn, "w").close()
    history = {"nit": [], "energy": [], "lh_chisq": {}, "prior_chisq": {}}
    for i in range(state.nit, opt_vi.n_total_iterations):
        logger.info(f"OPTIMIZE_KL: Starting {i + 1:04d}")
        samples, state = opt_vi.update(samples, state)
        whole_state = opt_vi.gather_state(state) if across else state
        msg = opt_vi.get_status_message(samples, whole_state, name="OPTIMIZE_KL")
        logger.info(msg)
        if odir:
            stats = _residual_stats(opt_vi, samples)
            if export_operators:
                _export_operator_outputs(odir, export_operators, samples, state.nit, opt_vi, writes)
            whole = opt_vi.gather(samples) if across else samples
            if writes:
                with open(sanity_fn, "a") as f:
                    f.write("\n" + msg)
                _record_history(history, state, *stats)
                _export_history(odir, history)
                io.dump((whole, whole_state._replace(config={})), last_fn)
        if callback is not None:
            callback(samples, state)
    if barrier is not None:
        barrier()
    return samples, state
