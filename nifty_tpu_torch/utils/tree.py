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
    "norm",
    "random_like",
    "size",
    "tree_axpy",
    "tree_map",
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
