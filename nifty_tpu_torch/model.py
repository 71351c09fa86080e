"""Generative-model core (counterpart of ``nifty_tpu/model.py``).

A model is a :class:`torch.nn.Module` with a ``domain``: a dict mapping
each latent parameter name to its :class:`ShapeWithDtype` (or one
:class:`ShapeWithDtype`).  Its arrays (mode tables, index tables, data)
are buffers, so ``model.to(device, dtype)`` moves them and casts the
floating ones.  Positions are ``dict[str, Tensor]``, so ``torch.func.jvp``
/``vjp`` apply to a model directly.  :class:`Initializer` draws a position
from a :class:`torch.Generator`.

:class:`LazyModel` derives what is not given: the ``domain`` from the
initializer and the ``target`` from a call, both on ``meta`` tensors
(:func:`eval_shape`, the counterpart of ``jax.eval_shape``: the model's
parameters and buffers are swapped for ``meta`` ones, and the kernel
Functions return empty outputs of the right shape there), so nothing
runs on the card to learn a shape.  The combinators: :class:`ChainModel`,
:class:`RematModel` (recompute instead of store under AD),
:class:`VModel` (``torch.func.vmap`` over a new axis) and
:class:`ClipModel`.
"""

from __future__ import annotations

import itertools
import warnings
from collections.abc import Iterable, Mapping
from functools import partial
from typing import Callable, Optional

import torch
from torch.utils._pytree import tree_flatten, tree_structure, tree_unflatten

from . import device as _device
from .logger import logger
from .utils.tree import ShapeWithDtype, random_like, tree_map

__all__ = [
    "ChainModel",
    "ClipModel",
    "Initializer",
    "LazyModel",
    "Model",
    "RematModel",
    "VModel",
    "WrappedCall",
    "eval_shape",
]


def _is_shape(x):
    return isinstance(x, ShapeWithDtype)


class Initializer:
    """A dict of per-parameter draw functions
    ``f(generator, *, device, dtype) -> Tensor``, or one such function.
    Two dict initializers merge with ``|``.  ``device=None`` draws on the
    CUDA card (raises without one)."""

    def __init__(self, call_or_struct):
        if isinstance(call_or_struct, Initializer):
            call_or_struct = call_or_struct._call_or_struct
        self._call_or_struct = call_or_struct

    @property
    def stupid(self) -> bool:
        """True for one opaque draw function rather than a dict of them."""
        return callable(self._call_or_struct)

    def __call__(self, generator, *, device=None, dtype=None):
        device = _device.resolve(device)
        if self.stupid:
            return self._call_or_struct(generator, device=device, dtype=dtype)
        return {
            k: self._call_or_struct[k](generator, device=device, dtype=dtype)
            for k in sorted(self._call_or_struct)
        }

    def __or__(self, other):
        other = other if isinstance(other, Initializer) else Initializer(other)
        if self.stupid or other.stupid:
            return NotImplemented
        return Initializer({**self._call_or_struct, **other._call_or_struct})

    def __getitem__(self, key):
        if self.stupid:
            raise NotImplementedError("opaque initializer is not indexable")
        return Initializer(self._call_or_struct[key])

    def __repr__(self):
        return f"Initializer({self._call_or_struct!r})"


def _white(domain):
    if isinstance(domain, ShapeWithDtype):
        return partial(random_like, primals=domain)
    return {k: partial(random_like, primals=v) for k, v in domain.items()}


def _float_dtype(module):
    """The dtype of the first floating buffer or parameter of ``module``."""
    if isinstance(module, torch.nn.Module):
        for t in itertools.chain(module.buffers(), module.parameters()):
            if t.is_floating_point():
                return t.dtype
    return torch.get_default_dtype()


def _on_meta(shapes, dtype):
    return tree_map(lambda s: torch.empty(s.shape, dtype=s.dtype or dtype, device="meta"),
                    shapes, is_leaf=_is_shape)


def eval_shape(fn, *shapes):
    """The output of ``fn(*args)`` as a tree of :class:`ShapeWithDtype`, the
    ``args`` ``meta`` tensors of the trees ``shapes`` (a leaf without a
    dtype takes ``fn``'s floating dtype).  A module ``fn`` runs with its
    parameters and buffers swapped for ``meta`` tensors
    (``torch.func.functional_call``): no memory is touched and no kernel
    is launched."""
    dtype = _float_dtype(fn)
    args = tuple(_on_meta(s, dtype) for s in shapes)
    if isinstance(fn, torch.nn.Module):
        state = {n: torch.empty_like(t, device="meta") for n, t in itertools.chain(
            fn.named_parameters(remove_duplicate=False), fn.named_buffers(remove_duplicate=False))}
        out = torch.func.functional_call(fn, state, args)
    else:
        out = fn(*args)
    return tree_map(ShapeWithDtype.from_leave, out)


class LazyModel(torch.nn.Module):
    """A model that derives what it is not given: ``domain`` from the
    shapes and dtypes of ``init`` (drawn on ``meta``; a leaf drawn in the
    dtype it is asked for records none, i.e. the model's), ``target`` from
    a call over
    ``domain`` (:func:`eval_shape`), and a white standard-normal ``init``
    over ``domain``, with a warning."""

    def __init__(self, *, domain=None, target=None, init=None):
        super().__init__()
        self._domain = domain
        self._target = target
        self._init = None if init is None else Initializer(init)

    @property
    def domain(self):
        if self._domain is None and self._init is not None:
            draw = partial(self._init, torch.Generator(), device="meta")
            self._domain = tree_map(
                lambda a, b: ShapeWithDtype(a.shape, None if a.dtype != b.dtype else a.dtype),
                draw(dtype=torch.float32), draw(dtype=torch.float64))
        return self._domain

    @property
    def target(self):
        if self._target is None and self.domain is not None:
            self._target = eval_shape(self, self.domain)
        return self._target

    @property
    def init(self) -> Initializer:
        if self._init is None:
            warnings.warn("no initializer set; drawing white standard-normal parameters"
                          " over the model domain")
            return Initializer(_white(self.domain))
        return self._init


class Model(LazyModel):
    """A callable joined with its domain and an initializer (white
    standard-normal draws over the domain unless ``init`` is given; with
    ``init`` alone the domain is its shapes)."""

    def __init__(self, call: Optional[Callable] = None, *, domain=None, init=None, target=None):
        if domain is None and init is None:
            raise ValueError("one of `init` or `domain` must be set")
        if init is None:
            init = _white(domain)
        super().__init__(domain=domain, init=init, target=target)
        self._call = call

    def forward(self, *args, **kwargs):
        return self._call(*args, **kwargs)


class WrappedCall(Model):
    """Applies ``call`` to the entry ``x[name]`` of a dict input, or to the
    input itself when ``name`` is None."""

    def __init__(self, call: Callable, *, name: Optional[str] = None, shape=(), dtype=None):
        swd = shape if isinstance(shape, ShapeWithDtype) else ShapeWithDtype(shape, dtype)
        super().__init__(call, domain=swd if name is None else {name: swd})
        self.name = name

    def forward(self, x):
        return self._call(x if self.name is None else x[self.name])


class ChainModel(Model):
    """``outer`` after ``inner``; ``outer`` may be a model or any callable
    (``torch.exp``, say)."""

    def __init__(self, outer: Callable, inner: Model):
        super().__init__(domain=inner.domain, init=inner.init)
        self.outer = outer
        self.inner = inner

    def forward(self, x, **kw):
        return self.outer(self.inner(x, **kw))


def _flat_call(model, in_spec):
    """``model`` as a function of the position's leaves to its output's."""
    def flat(*leaves):
        return tuple(tree_flatten(model(tree_unflatten(list(leaves), in_spec)))[0])

    return flat


def _pullback(model, in_spec, n_in, *args):
    """The vjp of ``model`` at the leaves ``args[:n_in]``, applied to the
    output cotangents ``args[n_in:]``, recomputing the forward."""
    _, vjp_fn = torch.func.vjp(_flat_call(model, in_spec), *args[:n_in])
    return tuple(vjp_fn(tuple(args[n_in:])))


class _RematPullback(torch.autograd.Function):
    """:class:`_Remat`'s pull-back as a Function of its own: under
    ``torch.func.vmap`` its rule maps :func:`_pullback` at the level below,
    where no gradient transform is active (a ``torch.func.vjp`` called in a
    backward that runs under ``vmap`` trips functorch)."""

    @staticmethod
    def forward(model, in_spec, n_in, *args):
        return _pullback(model, in_spec, n_in, *args)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def vmap(info, in_dims, model, in_spec, n_in, *args):
        out = torch.func.vmap(partial(_pullback, model, in_spec, n_in), in_dims=tuple(in_dims[3:]))(*args)
        return out, (0,) * len(out)


class _SpecBox:
    """Where :class:`_Remat`'s forward leaves the output's tree structure
    (an object, not a list: ``torch.func`` flattens list arguments)."""

    spec = None


class _Remat(torch.autograd.Function):
    """``model(x)`` that keeps no intermediate for AD: the forward runs
    without a graph, and ``backward`` and ``jvp`` run the model again under
    ``torch.func.vjp`` / ``torch.func.jvp`` from the saved input.  The
    model and the tree structures ride along as non-tensor arguments; the
    position's leaves are the tensor inputs and the output's leaves the
    outputs.  Its vmap rule re-enters through ``apply`` with the model
    mapped by ``torch.func.vmap``, so the recomputation in ``backward`` and
    ``jvp`` runs on the whole batch; ``backward`` goes through
    :class:`_RematPullback`, which holds under a ``vmap`` of the vjp."""

    @staticmethod
    def forward(model, in_spec, out_box, *leaves):
        out = model(tree_unflatten(list(leaves), in_spec))
        flat, out_box.spec = tree_flatten(out)
        return tuple(flat)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.model, ctx.in_spec, ctx.out_box = inputs[:3]
        ctx.save_for_backward(*inputs[3:])
        ctx.save_for_forward(*inputs[3:])

    @staticmethod
    def backward(ctx, *cots):
        leaves = ctx.saved_tensors
        grads = _RematPullback.apply(ctx.model, ctx.in_spec, len(leaves), *leaves, *cots)
        return (None, None, None) + tuple(grads)

    @staticmethod
    def jvp(ctx, _m, _s, _b, *tangents):
        flat = _flat_call(ctx.model, ctx.in_spec)
        return torch.func.jvp(flat, tuple(ctx.saved_tensors), tangents)[1]

    @staticmethod
    def vmap(info, in_dims, model, in_spec, out_box, *leaves):
        dims = tree_unflatten(list(in_dims[3:]), in_spec)
        mapped = torch.func.vmap(model, in_dims=(dims,))
        out = _Remat.apply(mapped, in_spec, out_box, *leaves)
        return out, (0,) * len(out)


class RematModel(Model):
    """The wrapped model, recomputed under AD instead of keeping its
    intermediates (``jax.checkpoint`` in the JAX package): inside the
    metric's jvp and vjp the forward holds nothing, and the pull-back runs
    the model once more from the position.  ``torch.utils.checkpoint``
    does not compose with ``torch.func`` transforms, hence a
    :class:`torch.autograd.Function`."""

    def __init__(self, inner):
        super().__init__(domain=inner.domain, init=inner.init)
        self.inner = inner

    def forward(self, x):
        leaves, spec = tree_flatten(x)
        box = _SpecBox()
        out = _Remat.apply(self.inner, spec, box, *leaves)
        return tree_unflatten(list(out), box.spec)


def _is_int_or_none(x):
    return x is None or isinstance(x, int)


def _parse_axes(axes, domain, what=""):
    """``axes`` as a tree of ints and Nones over ``domain``: one int for
    every leaf, a key (or key list) mapped at 0 and the rest None, or such
    a tree itself.  A dict tree with None leaves keeps them (the JAX
    package's ``_parse_axes`` reads any dict as a key list, so it maps
    every key of it at 0)."""
    leaves, spec = tree_flatten(domain, is_leaf=_is_shape)
    if isinstance(axes, int):
        return tree_unflatten([axes] * len(leaves), spec)
    if isinstance(axes, str):
        axes = (axes,)
    if (not isinstance(axes, Mapping) and isinstance(axes, Iterable)
            and all(isinstance(a, str) for a in axes)):
        return {k: (0 if k in axes else None) for k in domain}
    if tree_structure(axes) != spec:
        raise ValueError(f"{what} axes structure does not match the domain")
    return axes


class VModel(LazyModel):
    """``model`` mapped by ``torch.func.vmap`` over a new axis of size
    ``axis_size`` (``in_axes``: an int, a key or key list, or a tree of
    ints and Nones over the domain; ``out_axes`` the same over the
    target).  Its initializer draws each mapped parameter ``axis_size``
    times from the generator and stacks the draws along its axis."""

    def __init__(self, model, axis_size: int, in_axes=0, out_axes=0):
        if not isinstance(model, LazyModel):
            raise ValueError(f"model {model!r} of invalid type")
        if model.init.stupid:
            raise ValueError("can only vmap models with a structured init")
        if not isinstance(axis_size, int) or axis_size <= 0:
            raise ValueError(f"invalid axis_size {axis_size!r}")
        in_axes = _parse_axes(in_axes, model.domain, "domain")
        init_struct = model.init._call_or_struct

        def batched(f, axis):
            def draw(generator, *, device, dtype):
                return torch.stack([f(generator, device=device, dtype=dtype)
                                    for _ in range(axis_size)], dim=axis)

            return draw

        init = {k: f if in_axes.get(k) is None else batched(f, in_axes[k])
                for k, f in init_struct.items()}

        def mapped(k, s):
            if in_axes.get(k) is None:
                return s
            shape = list(s.shape)
            shape.insert(in_axes[k] % (len(shape) + 1), axis_size)
            return ShapeWithDtype(shape, s.dtype)

        super().__init__(domain={k: mapped(k, s) for k, s in model.domain.items()}, init=init)
        self.model = model
        self.axis_size = axis_size
        self.in_axes = in_axes
        self.out_axes = _parse_axes(out_axes, model.target, "target")

    def forward(self, x):
        axes = self.in_axes
        if isinstance(axes, dict) and isinstance(x, dict):
            axes = {k: axes.get(k) for k in x}
        return torch.func.vmap(self.model, in_dims=(axes,), out_dims=self.out_axes)(x)


class ClipModel(LazyModel):
    """Clip every latent input to ``[-threshold, threshold]`` (or through
    ``custom_clip_func``) before the wrapped model: a guard against latent
    blow-ups in line searches.  ``warn=True`` reads the largest input
    magnitude on the host and logs a warning above the threshold (a
    device synchronisation a call; not under ``torch.func.vmap``)."""

    def __init__(self, model, threshold: float = 10.0, warn: bool = False,
                 custom_clip_func: Optional[Callable] = None):
        super().__init__(init=model.init)
        self.model = model
        self.threshold = float(threshold)
        self.warn = bool(warn)
        self._custom_clip = custom_clip_func

    def _clip(self, leaf):
        if self._custom_clip is not None:
            return self._custom_clip(leaf)
        return torch.clamp(leaf, -self.threshold, self.threshold)

    def forward(self, x):
        leaves = tree_flatten(x)[0]
        if self.warn and leaves and leaves[0].device.type != "meta":
            mx = max(float(leaf.abs().max()) for leaf in leaves)
            if mx > self.threshold:
                logger.warning(f"ClipModel: clipping latent inputs (max |x| = {mx:.3e})")
        return self.model(tree_map(self._clip, x))
