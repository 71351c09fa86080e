"""Tree algebra over dicts of tensors (counterpart of ``nifty_tpu/utils/tree.py``).

Positions and tangents are ``dict[str, Tensor]`` (or a single tensor);
the functions here map over them with :mod:`torch.utils._pytree`, so the
same trees pass through ``torch.func`` transforms.  :class:`Vector` wraps
a tree with elementwise arithmetic.

Inside :func:`~..parallel.collectives.field_sharded` (a field-sharded
run) the leaves under the position keys it names are this rank's rows:
:func:`vdot`, :func:`dot`, :func:`norm`, :func:`size`, :func:`sample_vdot`
and :func:`sample_norm` sum those leaves' terms over the field group (the
other leaves are replicated and count once), so every rank reads the
whole field's value.

A forest is a tree whose leaves carry a leading sample axis.  The maps
over samples (:func:`get_map`) take forests: ``"vmap"`` batches a function
with ``torch.func.vmap`` (so every kernel Function runs once per batch),
``"lmap"`` loops.  :func:`sample_vdot` and :func:`sample_norm` reduce a
forest per sample, and :func:`tree_axpy` and :func:`where` broadcast
per-sample scalars ``(B,)`` along the leading axis: the solvers' batched
forms are written with them.
"""

from __future__ import annotations

import math
import numbers
import operator
from functools import partial

import numpy as np
import torch
from torch.utils import _pytree as pytree

from .. import device as _device

__all__ = [
    "ShapeWithDtype",
    "Vector",
    "assert_arithmetics",
    "dot",
    "full_like",
    "get_map",
    "has_arithmetics",
    "lmap",
    "map_forest",
    "map_forest_mean",
    "mean",
    "mean_and_std",
    "norm",
    "ones_like",
    "pmap",
    "counter_normal",
    "random_like",
    "ravel",
    "sample_norm",
    "sample_vdot",
    "size",
    "smap",
    "stack",
    "tree_add",
    "tree_axpy",
    "tree_map",
    "tree_sub",
    "unstack",
    "vdot",
    "vmap",
    "where",
    "zeros_like",
]


class ShapeWithDtype:
    """An abstract array: a shape and an optional torch dtype."""

    __slots__ = ("shape", "dtype")

    def __init__(self, shape=(), dtype=None):
        shape = (shape,) if isinstance(shape, int) else shape
        self.shape = tuple(int(s) for s in shape)
        self.dtype = dtype

    @classmethod
    def from_leave(cls, element):
        """The shape and dtype of the tensor ``element``."""
        return cls(tuple(element.shape), element.dtype)

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


def _shard_mask(tree):
    """``(group, mask)``: per leaf of ``tree`` (in its flattening order)
    whether it is a row shard of the active field context, or None outside
    one."""
    from ..parallel.collectives import field

    ctx = field()
    if ctx is None:
        return None
    mask = []

    def walk(t, inside):
        if isinstance(t, Vector):
            walk(t.tree, inside)
        elif isinstance(t, dict):
            for k, v in t.items():
                walk(v, inside or k in ctx.keys)
        elif isinstance(t, (list, tuple)):
            for v in t:
                walk(v, inside)
        else:
            mask.extend([inside] * len(pytree.tree_leaves(t)))

    walk(tree, False)
    return (ctx.group, mask) if any(mask) else None


def _total(terms, tree):
    """Σ ``terms`` (one a leaf of ``tree``) in leaf order, each row shard's
    term summed over the field group first (so one rank adds in the order
    of the unsharded run)."""
    sharded = _shard_mask(tree)
    if sharded is not None:
        from ..parallel.collectives import reduce_sum

        group, mask = sharded
        terms = [reduce_sum(t, group) if m else t for t, m in zip(terms, mask)]
    return sum(terms[1:], terms[0])


def size(tree) -> int:
    """The number of entries of ``tree`` (of the whole field, in a
    field-sharded run)."""
    sharded = _shard_mask(tree)
    sizes = [x.numel() for x in _leaves(tree)]
    if sharded is None:
        return sum(sizes)
    import torch.distributed as dist

    p = dist.get_world_size(sharded[0])
    return sum(n * (p if m else 1) for n, m in zip(sizes, sharded[1]))


def vdot(a, b):
    """Tree-wide inner product ⟨a, b⟩, conjugating ``a``, as a 0-d tensor."""
    terms = [torch.vdot(x.reshape(-1), y.reshape(-1)) for x, y in zip(_leaves(a), _leaves(b))]
    return _total(terms, a)


def dot(a, b):
    """Tree-wide dot product Σ_leaves Σ a_i b_i, without conjugating ``a``,
    as a 0-d tensor."""
    terms = [(x.reshape(-1) * y.reshape(-1)).sum() for x, y in zip(_leaves(a), _leaves(b))]
    return _total(terms, a)


def norm(tree, ord=2):
    """Tree-wide p-norm of the concatenated leaves, as a 0-d tensor."""
    leaves = _leaves(tree)
    if ord == float("inf"):
        top = torch.stack([x.abs().max() for x in leaves]).max()
        sharded = _shard_mask(tree)
        if sharded is not None:
            import torch.distributed as dist

            from ..parallel.collectives import _all_reduce

            top = _all_reduce(top, sharded[0], op=dist.ReduceOp.MAX)
        return top
    total = _total([x.abs().pow(ord).sum() for x in leaves], tree)
    return total ** (1.0 / ord)


def _lead(s, x):
    """A per-sample scalar ``s`` (a ``(B,)`` tensor) shaped to broadcast
    along the leading axis of ``x``; anything else as it is."""
    if isinstance(s, torch.Tensor) and s.ndim:
        return s.reshape(tuple(s.shape) + (1,) * (x.ndim - s.ndim))
    return s


def tree_axpy(alpha, x, y):
    """``y + alpha * x`` over the trees, in ``y``'s dtypes (a float64 step
    times a 0-d float32 leaf would promote it); a ``(B,)`` ``alpha`` scales
    each sample of forests ``x``, ``y``."""
    return tree_map(lambda xe, ye: ye + (_lead(alpha, xe) * xe).to(ye.dtype), x, y)


def where(cond, a, b):
    """``a`` where ``cond``, else ``b``, leafwise; a ``(B,)`` ``cond``
    selects whole samples of forests."""
    return tree_map(lambda x, y: torch.where(_lead(cond, x), x, y), a, b)


def sample_vdot(a, b):
    """:func:`vdot` of each sample of two forests, shape ``(B,)``: a product
    and a row sum a leaf (``torch.func.vmap`` of :func:`vdot` runs a
    batched matrix product, which took 0.56 ms a call at 4 × 1280² on an
    H100)."""
    terms = [
        (x.conj() * y).reshape(x.shape[0], -1).sum(-1) for x, y in zip(_leaves(a), _leaves(b))
    ]
    return _total(terms, a)


def sample_norm(forest, ord=2):
    """:func:`norm` of each sample of a forest, shape ``(B,)``."""
    return torch.func.vmap(partial(norm, ord=ord))(forest)


def full_like(tree, fill_value, *, device=None):
    """A tree like ``tree`` filled with ``fill_value``: a tensor leaf's
    shape, dtype and device; a :class:`ShapeWithDtype` leaf's shape and
    dtype on ``device`` (the CUDA card by default)."""

    def fill(x):
        if isinstance(x, ShapeWithDtype):
            return torch.full(x.shape, fill_value, dtype=x.dtype, device=_device.resolve(device))
        return torch.full_like(x, fill_value)

    return pytree.tree_map(fill, tree, is_leaf=lambda x: isinstance(x, ShapeWithDtype))


def zeros_like(tree):
    return tree_map(torch.zeros_like, tree)


def ones_like(tree):
    return full_like(tree, 1)


def _is_arithmetic(x) -> bool:
    return isinstance(x, (torch.Tensor, np.ndarray, numbers.Number))


def has_arithmetics(tree) -> bool:
    """Whether every leaf of ``tree`` is a tensor, an array or a number."""
    return all(_is_arithmetic(x) for x in _leaves(tree))


def assert_arithmetics(tree):
    """Raise ``TypeError`` naming the leaves of ``tree`` that are neither
    tensors, arrays nor numbers."""
    bad = [x for x in _leaves(tree) if not _is_arithmetic(x)]
    if bad:
        raise TypeError(f"tree contains non-arithmetic leaves: {bad!r}")


def ravel(tree):
    """``(flat, unravel)``: the leaves of a tensor or a dict of tensors laid
    end to end, a dict's in sorted key order (the JAX package's
    ``ravel_pytree`` order), and the function that reshapes such a vector
    back into the tree."""
    tree = tree.tree if isinstance(tree, Vector) else tree
    keys = sorted(tree) if isinstance(tree, dict) else None
    leaves = [tree[k] for k in keys] if keys else [tree]
    shapes = [tuple(x.shape) for x in leaves]
    sizes = [math.prod(s) for s in shapes]

    def unravel(flat):
        parts = [p.reshape(s) for p, s in zip(torch.split(flat, sizes), shapes)]
        return dict(zip(keys, parts)) if keys else parts[0]

    return torch.cat([x.reshape(-1) for x in leaves]), unravel


def random_like(generator, primals, *, device=None, dtype=None):
    """Standard-normal draws shaped like ``primals`` (a tree of tensors or
    :class:`ShapeWithDtype`), from ``generator``, one leaf after another in
    the tree's order, on ``device`` (the CUDA card by default), in
    ``dtype`` or else each leaf's own.  A complex leaf draws complex normals
    whose real and imaginary parts each have variance ½, as the JAX
    package's do."""
    device = _device.resolve(device)

    def draw(p):
        dt = dtype if dtype is not None else (p.dtype or torch.get_default_dtype())
        return torch.randn(p.shape, generator=generator, device=device, dtype=dt)

    return pytree.tree_map(
        draw, primals, is_leaf=lambda x: isinstance(x, ShapeWithDtype)
    )


_REAL = {torch.complex64: torch.float32, torch.complex128: torch.float64}


def counter_normal(seed: int, leaf: int, shape, dtype=None, *, start: int = 0, device=None):
    """Standard normals of ``shape``: the entries ``[start, start + n)`` (``n``
    the shape's size) of leaf ``leaf`` of the counter-based draw ``seed``
    (K7, :func:`~..ops.cuda_normal.philox_normal`), on ``device`` (the CUDA
    card by default) in ``dtype`` (the default floating dtype by default).
    Each entry is a function of ``(seed, leaf, its index)`` alone, so a
    range drawn alone equals that range of the whole draw, bit for bit.  A
    complex entry takes the normals ``2 e`` and ``2 e + 1`` as its real and
    imaginary parts, each of variance ½."""
    from ..ops.cuda_normal import philox_normal

    device = _device.resolve(device)
    dt = dtype or torch.get_default_dtype()
    shape = tuple(int(s) for s in shape)
    n = math.prod(shape)
    if dt in _REAL:
        z = philox_normal(seed, leaf, 2 * start, 2 * n, _REAL[dt], device) * math.sqrt(0.5)
        return torch.view_as_complex(z.reshape(shape + (2,)))
    return philox_normal(seed, leaf, start, n, dt, device).reshape(shape)


def tree_add(a, b):
    return tree_map(operator.add, a, b)


def tree_sub(a, b):
    return tree_map(operator.sub, a, b)


# --- forests: trees with a leading sample axis ---------------------------------


def stack(trees):
    """Stack equal-structure trees along a new leading axis (empty fields,
    ``None``, stay empty)."""
    return tree_map(lambda *xs: None if xs[0] is None else torch.stack(xs), *trees)


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


_LOOPS = []  # the lengths of the lmap loops running, outermost first


def looped() -> int:
    """The samples the running :func:`lmap` loops map (the product of their
    lengths; 1 outside one), for a cache that keeps one entry a sample."""
    return math.prod(_LOOPS)


def lmap(fun, in_axes=0):
    """``fun`` mapped over the leading axis of its arguments by a Python loop
    (vmap's semantics: ``in_axes`` 0 maps an argument, None passes it
    whole); the outputs are stacked.  Every call sees one sample, so the
    kernels run on the shapes they were written for."""
    _check_axes(in_axes, "lmap")

    def mapped(*args):
        axes = in_axes if isinstance(in_axes, tuple) else (in_axes,)
        axes = axes + (axes[-1],) * (len(args) - len(axes))
        n = {_leaves(a)[0].shape[0] for a, ax in zip(args, axes) if ax == 0}
        if len(n) != 1:
            raise ValueError(f"inconsistent mapped lengths {n}")
        n = n.pop()
        _LOOPS.append(n)
        try:
            outs = [
                fun(*(a if ax is None else tree_map(lambda x, i=i: x[i], a) for a, ax in zip(args, axes)))
                for i in range(n)
            ]
        finally:
            _LOOPS.pop()
        return stack(outs)

    return mapped


# The JAX package's ``smap`` maps by ``lax.scan``, one sample's memory at a
# time; the host loop of :func:`lmap` does the same.
smap = lmap


def _check_axes(in_axes, name):
    axes = in_axes if isinstance(in_axes, tuple) else (in_axes,)
    if any(a not in (0, None) for a in axes):
        raise NotImplementedError(f"{name} maps the leading axis (in_axes 0 or None) only")


def vmap(fun, in_axes=0):
    """``fun`` mapped over the leading axis of its arguments by
    ``torch.func.vmap`` (``in_axes`` 0 maps an argument, None passes it
    whole; outputs stacked along a new leading axis).  The kernel Functions
    have vmap rules, so a batch is one launch of each kernel on the card.
    ``fun`` must not read a mapped value on the host nor draw random
    numbers."""
    _check_axes(in_axes, "vmap")
    return torch.func.vmap(fun, in_dims=in_axes, randomness="error")


def pmap(fun, in_axes=0):
    """``fun`` mapped over the leading axis of its arguments across the
    ranks of the default process group (one rank without one): each rank
    takes its share of the axis (``parallel.host_local_slice``), maps it by
    :func:`lmap`, and every rank gets all the outputs, stacked in order.
    Every rank must call it; every share must be non-empty."""
    _check_axes(in_axes, "pmap")
    from ..parallel.mesh import gather_axis
    from ..parallel.multihost import host_local_slice, process_count

    local_map = lmap(fun, in_axes=in_axes)

    def mapped(*args):
        axes = in_axes if isinstance(in_axes, tuple) else (in_axes,)
        axes = axes + (axes[-1],) * (len(args) - len(axes))
        n = next(_leaves(a)[0].shape[0] for a, ax in zip(args, axes) if ax == 0)
        p = process_count()
        if n < p:
            raise ValueError(f"pmap: {n} samples over {p} ranks leaves a rank none")
        lo, hi = host_local_slice(n)
        share = [tree_map(lambda x: x[lo:hi], a) if ax == 0 else a for a, ax in zip(args, axes)]
        out = local_map(*share)
        if p == 1:
            return out
        import torch.distributed as dist

        m = -(-n // p)  # shares of m or m - 1: pad to m, gather, keep each share
        sizes = [host_local_slice(n, count=p, index=r) for r in range(p)]

        def gather(x):
            pad = x.new_zeros((m - x.shape[0],) + tuple(x.shape[1:]))
            full = gather_axis(torch.cat([x, pad]), 0, dist.group.WORLD)
            return torch.cat([full[r * m : r * m + (b - a)] for r, (a, b) in enumerate(sizes)])

        return tree_map(gather, out)

    return mapped


def get_map(map_spec):
    """A map over samples: ``"vmap"`` (:func:`vmap`, a batch), ``"lmap"`` or
    ``"smap"`` (a loop, :func:`lmap`), ``"pmap"`` (across the ranks of the
    process group, :func:`pmap`), or a callable ``map(fun, in_axes=...)``."""
    if callable(map_spec):
        return map_spec
    spec = str(map_spec).lower()
    if spec == "vmap":
        return vmap
    if spec in ("lmap", "smap"):
        return lmap
    if spec == "pmap":
        return pmap
    raise ValueError(f"unknown map {map_spec!r}")


def map_forest(fun, map="vmap", in_axes=0, **kwargs):
    """``fun`` mapped over the leading axis of its arguments by the map
    :func:`get_map` resolves ``map`` to."""
    return get_map(map)(fun, in_axes=in_axes, **kwargs)


def map_forest_mean(fun, map="vmap", in_axes=0, **kwargs):
    """:func:`map_forest` followed by the :func:`mean` over the mapped axis."""
    mapped = map_forest(fun, map=map, in_axes=in_axes, **kwargs)

    def meaned(*args, **kw):
        return mean(mapped(*args, **kw))

    return meaned
