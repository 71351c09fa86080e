"""Tree algebra over dicts of tensors (counterpart of ``nifty_tpu/utils/tree.py``).

Positions and tangents are ``dict[str, Tensor]`` (or a single tensor);
the functions here map over them with :mod:`torch.utils._pytree`, so the
same trees pass through ``torch.func`` transforms.  :class:`Vector` wraps
a tree with elementwise arithmetic.
"""

from __future__ import annotations

import operator

import torch
from torch.utils import _pytree as pytree

from .. import device as _device

__all__ = [
    "ShapeWithDtype",
    "Vector",
    "get_map",
    "lmap",
    "mean",
    "mean_and_std",
    "norm",
    "random_like",
    "size",
    "stack",
    "tree_add",
    "tree_axpy",
    "tree_map",
    "tree_sub",
    "unstack",
    "vdot",
    "zeros_like",
]


class ShapeWithDtype:
    """An abstract array: a shape and an optional torch dtype."""

    __slots__ = ("shape", "dtype")

    def __init__(self, shape=(), dtype=None):
        shape = (shape,) if isinstance(shape, int) else shape
        self.shape = tuple(int(s) for s in shape)
        self.dtype = dtype

    def __eq__(self, other):
        return isinstance(other, ShapeWithDtype) and (self.shape, self.dtype) == (
            other.shape,
            other.dtype,
        )

    def __hash__(self):
        return hash((self.shape, self.dtype))

    def __repr__(self):
        return f"ShapeWithDtype(shape={self.shape}, dtype={self.dtype})"


tree_map = pytree.tree_map
_leaves = pytree.tree_leaves


class Vector:
    """A tree with elementwise arithmetic (``+ - * /`` with trees or scalars)."""

    def __init__(self, tree):
        self.tree = tree.tree if isinstance(tree, Vector) else tree

    def __getitem__(self, key):
        return self.tree[key]

    def __iter__(self):
        return iter(self.tree)

    def __len__(self):
        return len(self.tree)

    def keys(self):
        return self.tree.keys()

    def items(self):
        return self.tree.items()

    def values(self):
        return self.tree.values()

    def _binary(self, other, op):
        if isinstance(other, Vector):
            return Vector(tree_map(op, self.tree, other.tree))
        return Vector(tree_map(lambda x: op(x, other), self.tree))

    def __add__(self, o):
        return self._binary(o, operator.add)

    def __sub__(self, o):
        return self._binary(o, operator.sub)

    def __mul__(self, o):
        return self._binary(o, operator.mul)

    def __truediv__(self, o):
        return self._binary(o, operator.truediv)

    def __radd__(self, o):
        return self._binary(o, lambda x, y: y + x)

    def __rsub__(self, o):
        return self._binary(o, lambda x, y: y - x)

    def __rmul__(self, o):
        return self._binary(o, lambda x, y: y * x)

    def __neg__(self):
        return Vector(tree_map(operator.neg, self.tree))

    def __repr__(self):
        return f"Vector({self.tree!r})"


pytree.register_pytree_node(
    Vector,
    lambda v: ([v.tree], None),
    lambda children, _: Vector(children[0]),
    serialized_type_name="nifty_tpu_torch.utils.tree.Vector",
)


def size(tree) -> int:
    return sum(x.numel() for x in _leaves(tree))


def vdot(a, b):
    """Tree-wide inner product ⟨a, b⟩, conjugating ``a``, as a 0-d tensor."""
    terms = [torch.vdot(x.reshape(-1), y.reshape(-1)) for x, y in zip(_leaves(a), _leaves(b))]
    return sum(terms[1:], terms[0])


def norm(tree, ord=2):
    """Tree-wide p-norm of the concatenated leaves, as a 0-d tensor."""
    leaves = _leaves(tree)
    if ord == float("inf"):
        return torch.stack([x.abs().max() for x in leaves]).max()
    total = sum(x.abs().pow(ord).sum() for x in leaves)
    return total ** (1.0 / ord)


def tree_axpy(alpha, x, y):
    """``y + alpha * x`` over the trees."""
    return tree_map(lambda xe, ye: ye + alpha * xe, x, y)


def zeros_like(tree):
    return tree_map(torch.zeros_like, tree)


def random_like(generator, primals, *, device=None, dtype=None):
    """Standard-normal draws shaped like ``primals`` (a tree of tensors or
    :class:`ShapeWithDtype`), from ``generator``, one leaf after another in
    the tree's order, on ``device`` (the CUDA card by default)."""
    device = _device.resolve(device)

    def draw(p):
        dt = dtype if dtype is not None else (p.dtype or torch.get_default_dtype())
        return torch.randn(p.shape, generator=generator, device=device, dtype=dt)

    return pytree.tree_map(
        draw, primals, is_leaf=lambda x: isinstance(x, ShapeWithDtype)
    )


def tree_add(a, b):
    return tree_map(operator.add, a, b)


def tree_sub(a, b):
    return tree_map(operator.sub, a, b)


# --- forests: trees with a leading sample axis ---------------------------------


def stack(trees):
    """Stack equal-structure trees along a new leading axis."""
    return tree_map(lambda *xs: torch.stack(xs), *trees)


def unstack(tree):
    """The trees of :func:`stack`'s leading axis, as a tuple."""
    leaves = _leaves(tree)
    n = leaves[0].shape[0] if leaves else 0
    return tuple(tree_map(lambda x, i=i: x[i], tree) for i in range(n))


def mean(forest):
    """Mean over a sequence of trees or over the leading axis of one tree."""
    if isinstance(forest, (list, tuple)):
        forest = stack(forest)
    return tree_map(lambda x: x.mean(dim=0), forest)


def mean_and_std(forest, correct_bias=True):
    """Mean and standard deviation (``ddof=1`` when ``correct_bias``) over a
    sequence of trees or over the leading axis of one tree."""
    if isinstance(forest, (list, tuple)):
        forest = stack(forest)
    m = tree_map(lambda x: x.mean(dim=0), forest)
    s = tree_map(lambda x: x.std(dim=0, correction=1 if correct_bias else 0), forest)
    return m, s


def lmap(fun, in_axes=0):
    """``fun`` mapped over the leading axis of its arguments by a Python loop
    (vmap's semantics: ``in_axes`` 0 maps an argument, None passes it
    whole); the outputs are stacked.  Every call sees one sample, so the
    kernels run on the shapes they were written for."""
    def mapped(*args):
        axes = in_axes if isinstance(in_axes, tuple) else (in_axes,)
        axes = axes + (axes[-1],) * (len(args) - len(axes))
        if any(a not in (0, None) for a in axes):
            raise NotImplementedError("lmap maps the leading axis (in_axes 0 or None) only")
        n = {_leaves(a)[0].shape[0] for a, ax in zip(args, axes) if ax == 0}
        if len(n) != 1:
            raise ValueError(f"inconsistent mapped lengths {n}")
        outs = [
            fun(*(a if ax is None else tree_map(lambda x, i=i: x[i], a) for a, ax in zip(args, axes)))
            for i in range(n.pop())
        ]
        return stack(outs)

    return mapped


def get_map(map_spec):
    """A map over samples: ``"lmap"`` or ``"smap"`` (a loop, :func:`lmap`) or
    a callable ``map(fun, in_axes=...)``.  ``"vmap"`` and ``"pmap"`` need
    batching rules for the kernel Functions and sharding, which are not
    ported (ROADMAP.md, section A, the queue after slice 4)."""
    if callable(map_spec):
        return map_spec
    spec = str(map_spec).lower()
    if spec in ("lmap", "smap"):
        return lmap
    if spec in ("vmap", "pmap"):
        raise NotImplementedError(
            f"map {map_spec!r}: batched sample maps need vmap rules for the kernel "
            "Functions and sharding (ROADMAP.md, section A: vmap or batched sample "
            "kernels, multi-GPU); use 'lmap'"
        )
    raise ValueError(f"unknown map {map_spec!r}")
