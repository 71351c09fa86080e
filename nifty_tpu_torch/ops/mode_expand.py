"""Expansion of unique-|k| mode tables onto harmonic grids (counterpart of
``nifty_tpu/ops/mode_expand.py``).

The exact correlated field stores one amplitude per unique |k| and expands
it onto the non-redundant core of the harmonic grid.  On a square grid the
core's |k| is symmetric under transposition, so the index is packed into
the rectangular-full-packed ("rfp2") layout, which halves the entries to
gather and to reduce; the unpack and its adjoint fold are plain layout ops.

:class:`ModeExpand` (gather, K1) and :class:`ModeCollapse` (segment sum,
K2) are each other's adjoints: the backward of one is the other, and the
jvp of each is itself (both are linear).  Backward and jvp re-enter the
Function through ``apply``, so under ``torch.func`` transforms the kernel
wrappers always receive plain tensors (``torch.func.jvp`` hands ``jvp`` a
wrapped tangent, which has no data pointer).  Tables are ``(U,)`` or ``(U, B)``
with a trailing sample axis.
"""

from __future__ import annotations

import hashlib
from collections import namedtuple

import numpy as np
import torch

from .cuda_expand import ExpandIndex, expand_gather, expand_segment_sum

__all__ = [
    "ExpandIndex",
    "ExpandLayout",
    "ModeCollapse",
    "ModeExpand",
    "build_expand_layout",
    "mode_collapse",
    "mode_expand",
]

ExpandLayout = namedtuple(
    "ExpandLayout",
    ("kind", "core_shape", "packed_shape", "n_unique", "idx_hash"),
)


def _idx_hash(core_idx: np.ndarray) -> str:
    h = hashlib.sha1()
    h.update(str(core_idx.shape).encode())
    h.update(np.ascontiguousarray(core_idx, dtype=np.int64).tobytes())
    return h.hexdigest()[:16]


def _rfp_index_table(core: np.ndarray) -> np.ndarray:
    """Pack the upper triangle of a symmetric (H, H) index table (H odd)
    into the rectangular-full-packed ((H+1)/2, H) layout."""
    H = core.shape[0]
    m = H // 2  # H = 2m + 1
    R = np.empty((m + 1, H), dtype=core.dtype)
    # right block: full rectangle rows 0..m, cols m+1..H-1
    R[:, m + 1 :] = core[: m + 1, m + 1 :]
    # left square S (m+1, m+1): upper triangle holds core[a, b] (a<=b<=m);
    # strict lower S[a, b] (a>b) holds core[m+1+b, m+a]
    aa, bb = np.meshgrid(np.arange(m + 1), np.arange(m + 1), indexing="ij")
    upper = core[: m + 1, : m + 1]
    lower_src = core[np.minimum(m + 1 + bb, H - 1), np.minimum(m + aa, H - 1)]
    R[:, : m + 1] = np.where(aa <= bb, upper, lower_src)
    return R


def build_expand_layout(core_idx: np.ndarray, n_unique: int):
    """Static layout and packed int32 index for a mode table.

    Returns ``(packed_idx, layout)``, both numpy / plain Python; wrap them
    in an :class:`ExpandIndex` to use them on tensors.
    """
    core_idx = np.asarray(core_idx)
    core_shape = tuple(int(n) for n in core_idx.shape)
    if (
        core_idx.ndim == 2
        and core_shape[0] == core_shape[1]
        and core_shape[0] % 2 == 1
        and np.array_equal(core_idx, core_idx.T)
    ):
        R = np.ascontiguousarray(_rfp_index_table(core_idx), dtype=np.int32)
        return R, ExpandLayout(
            kind="rfp2",
            core_shape=core_shape,
            packed_shape=tuple(int(n) for n in R.shape),
            n_unique=int(n_unique),
            idx_hash=_idx_hash(R),
        )
    return np.ascontiguousarray(core_idx, dtype=np.int32), ExpandLayout(
        kind="flat",
        core_shape=core_shape,
        packed_shape=core_shape,
        n_unique=int(n_unique),
        idx_hash=_idx_hash(core_idx),
    )


def _sym_from_upper(up):
    """(..., n, n) upper-triangular (incl. diagonal) -> symmetric."""
    return up + torch.triu(up, 1).transpose(-2, -1)


def _upper_cot(cot):
    """Adjoint of :func:`_sym_from_upper`."""
    return torch.triu(cot) + torch.triu(cot.transpose(-2, -1), 1)


def _unpack_rfp2(G, layout):
    """(B, m+1, H) packed gather result -> (B, H, H) core."""
    m = layout.core_shape[0] // 2
    S = G[..., :, : m + 1]
    rect = G[..., :, m + 1 :]
    C11 = _sym_from_upper(torch.triu(S))
    B2u = torch.tril(S, -1).transpose(-2, -1)  # [b, a] holds core[m+1+b, m+a]
    C22 = _sym_from_upper(B2u[..., :m, 1:])
    top = torch.cat([C11, rect], dim=-1)
    bottom = torch.cat([rect.transpose(-2, -1), C22], dim=-1)
    return torch.cat([top, bottom], dim=-2)


def _fold_rfp2(cot, layout):
    """Exact adjoint of :func:`_unpack_rfp2`: (B, H, H) -> (B, m+1, H)."""
    m = layout.core_shape[0] // 2
    u11 = cot[..., : m + 1, : m + 1]
    u12 = cot[..., : m + 1, m + 1 :]
    u21 = cot[..., m + 1 :, : m + 1]
    u22 = cot[..., m + 1 :, m + 1 :]
    rect_cot = u12 + u21.transpose(-2, -1)
    tri_cot = torch.triu(_upper_cot(u11))
    b2u_cot = torch.nn.functional.pad(_upper_cot(u22), (1, 0, 0, 1))
    s_lower_cot = torch.tril(b2u_cot.transpose(-2, -1), -1)
    return torch.cat([tri_cot + s_lower_cot, rect_cot], dim=-1)


def _expand(tab, index: ExpandIndex):
    layout = index.layout
    single = tab.ndim == 1
    flat = expand_gather(tab.contiguous(), index)
    G = flat.reshape(layout.packed_shape + (() if single else (tab.shape[-1],)))
    if layout.kind == "rfp2":
        G2 = G[None] if single else torch.movedim(G, -1, 0)
        core = _unpack_rfp2(G2, layout)
        return core[0] if single else torch.movedim(core, 0, -1)
    return G


def _collapse(cot, index: ExpandIndex):
    layout = index.layout
    single = cot.ndim == len(layout.core_shape)
    if layout.kind == "rfp2":
        c2 = cot[None] if single else torch.movedim(cot, -1, 0)
        R = _fold_rfp2(c2, layout)
        cot = R[0] if single else torch.movedim(R, 0, -1)
    flat = cot.reshape((-1,) if single else (-1, cot.shape[-1])).contiguous()
    return expand_segment_sum(flat, index)


class ModeExpand(torch.autograd.Function):
    """``tab`` (U,) / (U, B) -> core grid (+ trailing B), through K1."""

    @staticmethod
    def forward(tab, index):
        return _expand(tab, index)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.index = inputs[1]

    @staticmethod
    def backward(ctx, grad):
        return ModeCollapse.apply(grad, ctx.index), None

    @staticmethod
    def jvp(ctx, tab_t, _):
        return ModeExpand.apply(tab_t, ctx.index)


class ModeCollapse(torch.autograd.Function):
    """Core-grid cotangent (+ trailing B) -> (U,) / (U, B), through K2."""

    @staticmethod
    def forward(cot, index):
        return _collapse(cot, index)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.index = inputs[1]

    @staticmethod
    def backward(ctx, grad):
        return ModeExpand.apply(grad, ctx.index), None

    @staticmethod
    def jvp(ctx, cot_t, _):
        return ModeCollapse.apply(cot_t, ctx.index)


def mode_expand(tab, index: ExpandIndex):
    """Expand per-unique-mode values onto the core harmonic grid.

    Exactly equal to ``tab[core_idx]``; its transpose is the segment sum
    over the mode bins (:func:`mode_collapse`)."""
    return ModeExpand.apply(tab, index)


def mode_collapse(cot, index: ExpandIndex):
    """The adjoint of :func:`mode_expand`."""
    return ModeCollapse.apply(cot, index)
