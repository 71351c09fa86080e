"""Strings as pytree nodes without leaves (counterpart of
``nifty_tpu/utils/pytree_string.py``).

A :class:`PyTreeString` flattens to no children, its text the node's
context, so ``torch.utils._pytree.tree_map`` and ``tree_flatten`` (and with
them ``torch.func`` transforms of trees) carry names through untouched.
"""

from torch.utils import _pytree as pytree

__all__ = ["PyTreeString", "hide_strings"]


class PyTreeString:
    """A string registered as a pytree node with no children."""

    __slots__ = ("_s",)

    def __init__(self, s):
        self._s = str(s)

    def __str__(self):
        return self._s

    def __repr__(self):
        return f"PyTreeString({self._s!r})"

    def __eq__(self, other):
        o = other._s if isinstance(other, PyTreeString) else other
        return self._s == o

    def __hash__(self):
        return hash(self._s)

    def __add__(self, other):
        o = other._s if isinstance(other, PyTreeString) else other
        return PyTreeString(self._s + o)

    def lower(self):
        return PyTreeString(self._s.lower())

    def upper(self):
        return PyTreeString(self._s.upper())


pytree.register_pytree_node(
    PyTreeString,
    lambda s: ([], s._s),
    lambda _children, text: PyTreeString(text),
    serialized_type_name="nifty_tpu_torch.utils.pytree_string.PyTreeString",
)


def hide_strings(tree):
    """``tree`` with every ``str`` leaf wrapped in a :class:`PyTreeString`."""
    return pytree.tree_map(lambda x: PyTreeString(x) if isinstance(x, str) else x, tree)
