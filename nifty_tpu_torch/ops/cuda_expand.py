"""The mode-table expansion on the card: K1 (table -> full grid) and K2
(full-grid cotangent -> table).

K1 replaces the Pallas kernel ``nifty_tpu/ops/pallas_expand.py:forward_fn``
(``out[p] = tab[idx[p]]`` on the packed index) together with the layout ops
the JAX package runs after it: the unpack of the rfp2 packing onto the
``(H, H)`` core and the mirror unfold of the core onto the full harmonic
grid.  K2 replaces ``:transpose_fn`` (the segment sum over the mode bins)
with the mirror's and the unpack's adjoints in front of it.  On the TPU
the kernels ran a Clos routing network of lane shuffles, because XLA:TPU
gathers cost a fixed ~7 ns per index.  On Hopper both are bound by the
bytes of the full grid; ``csrc/expand.cu`` says how each kernel answers
that.

Both take ``(U,)`` tables and ``(U, B)`` tables batched over a trailing
sample axis; the grid side is ``full_shape`` (+ ``B``), where each axis of
the full shape is either the core's (not mirrored) or ``2 (c - 1)`` or
``2 c - 1`` for a core of ``c`` (mirrored: position ``i >= n//2+1`` takes
the value at ``n - i``).  K2 reduces over a CSR permutation of the packed
index that :class:`ExpandIndex` builds once on the host, in a fixed order
without atomics, so its sums are deterministic.

Each wrapper runs its plain PyTorch version (the composition of
``index_select``, the rfp2 unpack and the mirror unfold, and its adjoint
ending in ``index_add_``) when its tensor lies on the CPU; for a CUDA
tensor it launches its kernel or raises.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import native

__all__ = [
    "LARGE_BIN",
    "MAX_GRID_YZ",
    "ExpandIndex",
    "collapse_from_grid",
    "collapse_from_grid_plain",
    "expand_to_grid",
    "expand_to_grid_plain",
    "grid_geometry",
    "mirror_fold",
    "mirror_unfold",
    "segment_csr",
]

LARGE_BIN = 32  # bins with more members than this are reduced by a warp
MAX_GRID_YZ = 65535  # a launch grid's y and z extents


def segment_csr(idx: np.ndarray, n_unique: int):
    """CSR form of the bins of ``idx``: the stable argsort of the index,
    the bin offsets into it, and the bins of more than :data:`LARGE_BIN`
    members."""
    idx = np.asarray(idx).ravel()
    perm = np.argsort(idx, kind="stable")
    counts = np.bincount(idx, minlength=n_unique)
    offsets = np.concatenate([[0], np.cumsum(counts)])
    as32 = lambda a: torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32))
    return as32(perm), as32(offsets), as32(np.flatnonzero(counts > LARGE_BIN))


class ExpandIndex(torch.nn.Module):
    """A packed mode index and its CSR form, as buffers that follow the
    model to its device.  ``layout`` is the static
    :class:`~.mode_expand.ExpandLayout`."""

    def __init__(self, packed_idx, layout):
        super().__init__()
        idx = np.asarray(packed_idx).ravel()
        if idx.size and (idx.min() < 0 or idx.max() >= layout.n_unique):
            raise ValueError("mode index out of range")
        self.layout = layout
        self.register_buffer(
            "idx", torch.from_numpy(np.ascontiguousarray(idx, dtype=np.int32))
        )
        perm, offsets, large = segment_csr(idx, layout.n_unique)
        self.register_buffer("perm", perm)
        self.register_buffer("offsets", offsets)
        self.register_buffer("large_bins", large)

    @property
    def n_packed(self) -> int:
        return self.idx.numel()

    @property
    def n_unique(self) -> int:
        return self.layout.n_unique


def grid_geometry(layout, full_shape):
    """The kernels' geometry ``(n0, n1, n2, c0, c1, c2, m)``: the full and
    core shapes with leading axes of 1 up to three axes, and ``m = H // 2``
    for an rfp2 layout (its two axes last), else -1.  Raises unless each
    full axis is its core's or that core's mirror unfold."""
    core = tuple(layout.core_shape)
    full = tuple(int(n) for n in full_shape)
    if len(full) != len(core) or not 1 <= len(core) <= 3:
        raise ValueError(f"full shape {full} does not fit the core {core}")
    for n, c in zip(full, core):
        if n != c and n // 2 + 1 != c:
            raise ValueError(f"full shape {full} does not fit the core {core}")
    pad = (1,) * (3 - len(core))
    m = core[0] // 2 if layout.kind == "rfp2" else -1
    return pad + full + pad + core + (m,)


def mirror_unfold(core, full_shape):
    """Expand a core array (``n//2+1`` per axis, or ``n`` where an axis is
    not mirrored) to the full Fourier grid: position ``i >= n//2+1`` takes
    the value at ``n-i``.  Trailing axes beyond ``full_shape`` ride along."""
    out = core
    for axis, n in enumerate(full_shape):
        if out.shape[axis] == n:
            continue
        h = n // 2 + 1
        if out.shape[axis] != h:
            raise ValueError(f"core shape {tuple(core.shape)} does not fit {full_shape}")
        mirror = out.narrow(axis, 1, n - h).flip(axis)
        out = torch.cat([out, mirror], dim=axis)
    return out


def mirror_fold(cot, core_shape):
    """Exact adjoint of :func:`mirror_unfold`: full grid -> core."""
    out = cot
    for axis, h in enumerate(core_shape):
        n = out.shape[axis]
        if n == h:
            continue
        core = out.narrow(axis, 0, h)
        mirror = out.narrow(axis, h, n - h).flip(axis)
        pad = [0, 0] * (out.ndim - axis - 1) + [1, h - 1 - (n - h)]
        out = core + torch.nn.functional.pad(mirror, pad)
    return out


def _sym_from_upper(up):
    """(..., n, n) upper-triangular (incl. diagonal) -> symmetric."""
    return up + torch.triu(up, 1).transpose(-2, -1)


def _upper_cot(cot):
    """Adjoint of :func:`_sym_from_upper`."""
    return torch.triu(cot) + torch.triu(cot.transpose(-2, -1), 1)


def _unpack_rfp2(G, layout):
    """(B, m+1, H) packed values -> (B, H, H) core."""
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


def expand_to_grid_plain(tab, index: ExpandIndex, full_shape):
    """Plain version of K1: ``tab[idx]``, the rfp2 unpack, the mirror
    unfold."""
    layout = index.layout
    single = tab.ndim == 1
    G = tab.index_select(0, index.idx)
    G = G.reshape(layout.packed_shape + (() if single else (tab.shape[-1],)))
    if layout.kind == "rfp2":
        G2 = G[None] if single else torch.movedim(G, -1, 0)
        core = _unpack_rfp2(G2, layout)
        G = core[0] if single else torch.movedim(core, 0, -1)
    return mirror_unfold(G, full_shape)


def collapse_from_grid_plain(cot, index: ExpandIndex, full_shape):
    """Plain version of K2: the mirror fold, the rfp2 fold and
    ``index_add_`` over the bins."""
    layout = index.layout
    single = cot.ndim == len(full_shape)
    core = mirror_fold(cot, layout.core_shape)
    if layout.kind == "rfp2":
        c2 = core[None] if single else torch.movedim(core, -1, 0)
        R = _fold_rfp2(c2, layout)
        core = R[0] if single else torch.movedim(R, 0, -1)
    flat = core.reshape((-1,) if single else (-1, cot.shape[-1]))
    out = cot.new_zeros((index.n_unique,) + tuple(cot.shape[len(full_shape) :]))
    return out.index_add_(0, index.idx, flat)


def _check_cuda(t, index, shape, what):
    native.require_cuda(t, what, torch.float32, t.ndim in (len(shape), len(shape) + 1)
                        and tuple(t.shape[: len(shape)]) == tuple(shape))
    if index.idx.device != t.device:
        raise ValueError(f"{what}: index on {index.idx.device}, values on {t.device}")
    if t.ndim > len(shape) and t.shape[-1] % 4 == 0 and t.data_ptr() % 16:
        raise ValueError(
            f"{what}: a batch of a multiple of 4 is read in 16-byte vectors; "
            "the tensor must start on a 16-byte boundary"
        )


def _launch_geometry(index, full_shape, what):
    geom = grid_geometry(index.layout, full_shape)
    if max(geom[3:5]) > MAX_GRID_YZ:  # the core's rows and slabs are grid extents
        raise ValueError(f"{what}: core {index.layout.core_shape} is too large for a launch grid")
    return native.int_array(geom)


def expand_to_grid(tab, index: ExpandIndex, full_shape):
    """K1: ``(U,)`` or ``(U, B)`` table -> ``full_shape`` (+ ``(B,)``)."""
    if tab.device.type == "cpu":
        return expand_to_grid_plain(tab, index, full_shape)
    _check_cuda(tab, index, (index.n_unique,), "expand_to_grid")
    geom = _launch_geometry(index, full_shape, "expand_to_grid")
    B = 1 if tab.ndim == 1 else tab.shape[1]
    out = torch.empty(tuple(full_shape) + tuple(tab.shape[1:]), dtype=tab.dtype, device=tab.device)
    err = native.lib().nt_expand_to_grid(
        tab.data_ptr(), index.idx.data_ptr(), out.data_ptr(), geom, B, native.stream_of(tab)
    )
    native.check(err, "expand_to_grid")
    native.launches["expand_to_grid"] += 1
    return out


def collapse_from_grid(cot, index: ExpandIndex, full_shape):
    """K2: ``full_shape`` (+ ``(B,)``) cotangent -> ``(U,)`` or ``(U, B)``."""
    if cot.device.type == "cpu":
        return collapse_from_grid_plain(cot, index, full_shape)
    _check_cuda(cot, index, full_shape, "collapse_from_grid")
    geom = _launch_geometry(index, full_shape, "collapse_from_grid")
    batch = tuple(cot.shape[len(full_shape) :])
    B = batch[0] if batch else 1
    folded = torch.empty((index.n_packed,) + batch, dtype=cot.dtype, device=cot.device)
    out = torch.empty((index.n_unique,) + batch, dtype=cot.dtype, device=cot.device)
    err = native.lib().nt_collapse_from_grid(
        cot.data_ptr(), folded.data_ptr(), index.perm.data_ptr(), index.offsets.data_ptr(),
        index.n_unique, LARGE_BIN, index.large_bins.data_ptr(), index.large_bins.numel(),
        out.data_ptr(), geom, B, native.stream_of(cot),
    )
    native.check(err, "collapse_from_grid")
    native.launches["collapse_from_grid"] += 1
    return out
