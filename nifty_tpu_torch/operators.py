"""Structural linear operators as functions (counterpart of
``nifty_tpu/operators.py``).

Each structural transform is a plain function on tensors, or a factory
returning one: linearity is a property, not a class, and the adjoint of
any of them is :func:`adjoint` (``torch.func.vjp`` with the conjugation
that makes it the transpose).  They compose with models through
``ChainModel`` or ``Likelihood.amend`` and are checked by
``extra.check_linear_model``.  Constants given as numpy go to the device
and dtype of each input they meet (:class:`~.device.Const`); dict inputs
are the port's trees.
"""

from __future__ import annotations

from typing import Callable, Mapping, Optional, Sequence, Union

import numpy as np
import torch

from . import device as _device
from .device import Const
from .ops.ndimage import map_coordinates
from .utils.tree import ShapeWithDtype, Vector, tree_map

__all__ = [
    "adjoint",
    "scaling",
    "diagonal",
    "adder",
    "mask",
    "mask_adjoint",
    "zero_pad",
    "central_slice",
    "extract_at_indices",
    "contraction",
    "outer_product",
    "matrix_product",
    "block_diagonal",
    "transpose_field",
    "regrid",
    "linear_interpolation",
    "func_convolution",
    "squeeze",
    "prepend_key",
    "value_inserter",
    "multifield_to_vector",
    "vector_to_multifield",
    "partial_conjugate",
    "linear_einsum",
]


def _promoted(consts, x):
    """``consts`` and ``x`` in their common dtype, as JAX promotes them."""
    dtype = x.dtype
    for c in consts:
        dtype = torch.promote_types(dtype, c.dtype)
    return [c.like(x, dtype) for c in consts], x.to(dtype)


def _real_dtype(dtype):
    return dtype.to_real() if dtype.is_complex else dtype


def _conj(t):
    return t.conj().resolve_conj() if t.is_complex() else t


def adjoint(f: Callable, example_input, *, device=None):
    """The transpose of the linear map ``f``, as the JAX package's
    ``jax.linear_transpose``: ``conj(vjp(conj(y)))``.  ``example_input``
    is a tree of tensors, or of :class:`ShapeWithDtype` (zeros on
    ``device``, the CUDA card by default); the returned function maps
    cotangents of ``f``'s output to the input space."""
    def zeros(s):
        if isinstance(s, torch.Tensor):
            return s
        dev = _device.resolve(device)
        return torch.zeros(s.shape, dtype=s.dtype or torch.get_default_dtype(), device=dev)

    primal = tree_map(zeros, example_input, is_leaf=lambda s: isinstance(s, ShapeWithDtype))
    _, vjp_fn = torch.func.vjp(f, primal)

    def adj(y):
        return tree_map(_conj, vjp_fn(tree_map(_conj, y))[0])

    return adj


def scaling(factor):
    """× a scalar."""
    return lambda x: tree_map(lambda a: factor * a, x)


def _tree(x):
    return x.tree if isinstance(x, Vector) else x


def diagonal(diag):
    """Pointwise multiply by a fixed field (a tensor, numpy, or a dict)."""
    if isinstance(diag, (dict, Vector)):
        return lambda x: tree_map(lambda d, a: d * a, _tree(diag), _tree(x))
    c = Const(diag)
    return lambda x: c.like(x) * x


def adder(offset):
    """+ a fixed field (affine, not linear)."""
    if isinstance(offset, (dict, Vector)):
        return lambda x: tree_map(lambda o, a: o + a, _tree(offset), _tree(x))
    c = Const(offset)
    return lambda x: x + c.like(x)


def _kept(keep):
    keep = np.asarray(keep, bool)
    return keep, np.nonzero(keep.ravel())[0]


def mask(keep):
    """Project to the entries where ``keep`` is True, as a 1-D tensor of the
    surviving values (``keep`` flags included pixels)."""
    _, idx = _kept(keep)
    c = Const(idx)
    return lambda x: x.reshape(-1)[c.like(x)]


def mask_adjoint(keep):
    """Scatter masked values back into the full grid (zeros elsewhere)."""
    keep, idx = _kept(keep)
    c = Const(idx)

    def apply(y):
        out = y.new_zeros(keep.size).index_copy(0, c.like(y), y)  # indices are unique
        return out.reshape(keep.shape)

    return apply


def zero_pad(new_shape: Sequence[int], *, center: bool = False):
    """Embed a field into a larger grid, padding with zeros.

    ``center=False`` pads at the end of each axis.  ``center=True`` follows
    the reference's harmonic-layout convention: the zeros go in at the
    Nyquist split, the head ``x[:n//2+1]`` stays at the start of the axis
    and the tail ``x[-(n//2):]`` moves to the end (an even length's
    Nyquist bin lands in both)."""
    new_shape = tuple(int(s) for s in new_shape)

    def apply(x):
        if x.ndim != len(new_shape):
            raise ValueError(f"rank mismatch: {tuple(x.shape)} vs {new_shape}")
        if any(new < old for old, new in zip(x.shape, new_shape)):
            raise ValueError("zero_pad target must not be smaller")
        if not center:
            pad = []
            for old, new in zip(reversed(x.shape), reversed(new_shape)):
                pad += [0, new - old]
            return _pad(x, pad)
        for ax, new in enumerate(new_shape):
            old = x.shape[ax]
            if new == old:
                continue
            nyq = old // 2
            gap = list(x.shape)
            gap[ax] = new - 2 * nyq - 1
            x = torch.cat([x.narrow(ax, 0, nyq + 1), x.new_zeros(gap),
                           x.narrow(ax, old - nyq, nyq)], dim=ax)
        return x

    return apply


def _pad(x, pad):
    if x.is_complex():
        return torch.complex(torch.nn.functional.pad(x.real, pad),
                             torch.nn.functional.pad(x.imag, pad))
    return torch.nn.functional.pad(x, pad)


def central_slice(new_shape: Sequence[int], *, center: bool = False):
    """Cut the (corner, or with ``center`` central) ``new_shape`` region."""
    new_shape = tuple(int(s) for s in new_shape)

    def apply(x):
        for ax, (o, n) in enumerate(zip(x.shape, new_shape)):
            x = x.narrow(ax, (o - n) // 2 if center else 0, n)
        return x

    return apply


def extract_at_indices(indices, *, axis: int = 0):
    """Gather at static ``indices`` along ``axis``."""
    c = Const(np.asarray(indices))
    return lambda x: torch.index_select(x, axis, c.like(x).reshape(-1)).reshape(
        x.shape[:axis % x.ndim] + tuple(c.a.shape) + x.shape[axis % x.ndim + 1:])


def contraction(axes: Optional[Union[int, Sequence[int]]] = None, *, weights=None,
                mean: bool = False):
    """Sum (or weighted sum, or mean) over ``axes`` (all by default)."""
    if axes is not None and np.isscalar(axes):
        axes = (int(axes),)
    w = None if weights is None else Const(weights)

    def apply(x):
        y = x if w is None else x * w.like(x, _real_dtype(x.dtype))
        dims = tuple(range(x.ndim)) if axes is None else tuple(axes)
        return y.mean(dim=dims) if mean else y.sum(dim=dims)

    return apply


def outer_product(field):
    """x ↦ field ⊗ x."""
    c = Const(field)

    def apply(x):
        (f,), x = _promoted([c], x)
        return torch.tensordot(f, x, dims=0)

    return apply


def matrix_product(matrix, *, axis: int = -1):
    """Apply a dense matrix along one axis."""
    c = Const(matrix)

    def apply(x):
        (m,), x = _promoted([c], x)
        return torch.movedim(torch.movedim(x, axis, -1) @ m.T, -1, axis)

    return apply


def block_diagonal(fns: Mapping[str, Callable]):
    """Apply one (linear) function per key of a dict input; keys without an
    entry in ``fns`` pass through.  A key of ``fns`` absent from the input
    raises."""
    def apply(x):
        xd = _tree(x)
        unknown = set(fns) - set(xd)
        if unknown:
            raise KeyError(f"block_diagonal: keys {sorted(unknown)} not in input domain {sorted(xd)}")
        out = {k: fns[k](v) if k in fns else v for k, v in xd.items()}
        return Vector(out) if isinstance(x, Vector) else out

    return apply


def transpose_field(perm: Sequence[int]):
    """Permute field axes."""
    perm = tuple(int(p) for p in perm)
    return lambda x: x.permute(perm)


def _regrid_weights(n_out, n_in):
    """Output pixel centres in the input's fractional index space, two taps
    each (numpy, ``(n_out, n_in)``)."""
    pos = (np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5
    pos = np.clip(pos, 0.0, n_in - 1.0)
    lo = np.floor(pos).astype(int)
    hi = np.minimum(lo + 1, n_in - 1)
    w_hi = pos - lo
    mat = np.zeros((n_out, n_in))
    np.add.at(mat, (np.arange(n_out), lo), 1.0 - w_hi)
    np.add.at(mat, (np.arange(n_out), hi), w_hi)
    return mat


def regrid(new_shape: Sequence[int]):
    """Linear regridding between regular grids of the same extent: separable
    multilinear weights, one dense ``(n_out, n_in)`` matrix an axis applied
    by ``tensordot``."""
    new_shape = tuple(int(s) for s in new_shape)
    mats = {}

    def apply(x):
        for ax, n_out in enumerate(new_shape):
            n_in = x.shape[ax]
            if n_in != n_out:
                if (n_out, n_in) not in mats:
                    mats[(n_out, n_in)] = Const(_regrid_weights(n_out, n_in))
                w = mats[(n_out, n_in)].like(x, x.dtype)
                x = torch.movedim(torch.tensordot(w, torch.movedim(x, ax, 0), dims=1), 0, ax)
        return x

    return apply


def linear_interpolation(positions, *, distances, offset=None):
    """Multilinear interpolation of a regular grid at physical ``positions``
    ``(ndim, n_points)``; the positions wrap periodically (the grid is a
    torus)."""
    positions = np.asarray(positions, float)
    ndim, _ = positions.shape
    distances = (np.full(ndim, float(distances)) if np.isscalar(distances)
                 else np.asarray(distances, float))
    offset = np.zeros(ndim) if offset is None else np.asarray(offset, float)
    frac = Const((positions - offset[:, None]) / distances[:, None])

    def apply(x):
        return map_coordinates(x, frac.like(x), order=1, mode="wrap")

    return apply


def func_convolution(shape: Sequence[int], distances, func: Callable):
    """Convolution with an isotropic kernel ``func(r)`` (numpy radii) on a
    periodic regular grid by the convolution theorem: ``irfftn`` of the
    input's ``rfftn`` times the kernel's, held once per device."""
    shape = tuple(int(s) for s in shape)
    ndim = len(shape)
    distances = ((float(distances),) * ndim if np.isscalar(distances)
                 else tuple(float(d) for d in distances))
    axes = [np.minimum(np.arange(n), n - np.arange(n)) * d for n, d in zip(shape, distances)]
    mesh = np.meshgrid(*axes, indexing="ij")
    r = np.sqrt(sum(m**2 for m in mesh))
    kern_f = Const(np.fft.rfftn(np.asarray(func(r)) * float(np.prod(distances))))

    def apply(x):
        if x.is_complex():  # the kernel is real: convolve both parts
            return torch.complex(apply(x.real), apply(x.imag))
        k = kern_f.like(x, torch.complex64 if x.dtype == torch.float32 else torch.complex128)
        return torch.fft.irfftn(torch.fft.rfftn(x) * k, s=shape)

    return apply


def squeeze(axis=None):
    """Drop size-1 axes (all, or ``axis``)."""
    return lambda x: x.squeeze() if axis is None else x.squeeze(axis)


def prepend_key(key: str):
    """Nest a dict input under ``key``."""
    return lambda x: {key: _tree(x)}


def value_inserter(shape: Sequence[int], index):
    """Insert a scalar at a static position of a zero field."""
    shape = tuple(int(s) for s in shape)
    flat = int(np.ravel_multi_index(tuple(int(i) for i in index), shape))

    def apply(x):
        pos = torch.tensor([flat], device=x.device)
        return x.new_zeros(int(np.prod(shape))).index_copy(0, pos, x.reshape(1)).reshape(shape)

    return apply


def _sorted_leaves(tree):
    """The leaves in JAX's order: dict keys sorted, depth first."""
    if isinstance(tree, Vector):
        return _sorted_leaves(tree.tree)
    if isinstance(tree, Mapping):
        return [leaf for k in sorted(tree) for leaf in _sorted_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for t in tree for leaf in _sorted_leaves(t)]
    return [tree]


def multifield_to_vector(x):
    """Ravel a tree into one flat vector, its dict keys in sorted order (as
    ``jax.flatten_util.ravel_pytree``), the leaves promoted to one dtype."""
    leaves = _sorted_leaves(x)
    dtype = leaves[0].dtype
    for leaf in leaves[1:]:
        dtype = torch.promote_types(dtype, leaf.dtype)
    return torch.cat([leaf.reshape(-1).to(dtype) for leaf in leaves])


def _rebuild(example, it):
    if isinstance(example, Mapping):
        out = {k: None for k in example}
        for k in sorted(example):
            out[k] = _rebuild(example[k], it)
        return out
    if isinstance(example, (list, tuple)):
        return type(example)(_rebuild(e, it) for e in example)
    return next(it)


def vector_to_multifield(example):
    """The inverse of :func:`multifield_to_vector` for the structure,
    shapes and dtypes of ``example``."""
    leaves = _sorted_leaves(example)
    sizes = [leaf.numel() for leaf in leaves]

    def apply(flat):
        parts = torch.split(flat, sizes)
        out = iter([p.reshape(leaf.shape).to(leaf.dtype) for p, leaf in zip(parts, leaves)])
        tree = _rebuild(_tree(example), out)
        return Vector(tree) if isinstance(example, Vector) else tree

    return apply


def partial_conjugate(keys: Sequence[str]):
    """Conjugate the listed keys of a dict input."""
    keys = frozenset(keys)

    def apply(x):
        out = {k: _conj(v) if k in keys else v for k, v in _tree(x).items()}
        return Vector(out) if isinstance(x, Vector) else out

    return apply


def linear_einsum(subscripts: str, **tensors):
    """Einsum with fixed named tensors; the input is the last operand, e.g.
    ``linear_einsum("ij,j->i", m=mat)`` maps ``x ↦ mat @ x``."""
    consts = [Const(v) for v in tensors.values()]

    def apply(x):
        ts, x = _promoted(consts, x)
        return torch.einsum(subscripts, *ts, x)

    return apply
