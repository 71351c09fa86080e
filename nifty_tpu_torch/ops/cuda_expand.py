"""The mode-table expansion on the card: kernels K1 (gather) and K2 (segment sum).

Replaces the Pallas kernels ``nifty_tpu/ops/pallas_expand.py:forward_fn``
(K1, ``out[p] = tab[idx[p]]``) and ``:transpose_fn`` (K2, its exact
adjoint ``tab_cot[u] = sum over {p : idx[p] = u} of cot[p]``).  On the TPU
they ran a Clos routing network of lane shuffles, because XLA:TPU gathers
cost a fixed ~7 ns per index.  On Hopper both are bound by device-memory
bytes (4 B of index and 4·B B of values per packed entry) with the small
table served from L2; ``csrc/expand.cu`` says how each kernel answers that.

Both take ``(U,)`` tables and ``(U, B)`` tables batched over a trailing
sample axis.  K2 reduces over a CSR permutation of the index that
:class:`ExpandIndex` builds once on the host, in a fixed order without
atomics, so its sums are deterministic.

Each wrapper runs its plain PyTorch version (``index_select`` /
``index_add_``) when its tensor lies on the CPU; for a CUDA tensor it
launches its kernel or raises.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import native

__all__ = [
    "LARGE_BIN",
    "ExpandIndex",
    "expand_gather",
    "expand_gather_plain",
    "expand_segment_sum",
    "expand_segment_sum_plain",
    "segment_csr",
]

LARGE_BIN = 32  # bins with more members than this are reduced by a warp


def segment_csr(idx: np.ndarray, n_unique: int):
    """CSR form of the bins of ``idx``: the stable argsort of the index,
    the bin offsets, and the bins split into small and large ones."""
    idx = np.asarray(idx).ravel()
    perm = np.argsort(idx, kind="stable")
    counts = np.bincount(idx, minlength=n_unique)
    offsets = np.concatenate([[0], np.cumsum(counts)])
    bins = np.arange(n_unique)
    large = counts > LARGE_BIN
    as32 = lambda a: torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32))
    return as32(perm), as32(offsets), as32(bins[~large]), as32(bins[large])


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
        perm, offsets, small, large = segment_csr(idx, layout.n_unique)
        self.register_buffer("perm", perm)
        self.register_buffer("offsets", offsets)
        self.register_buffer("small_bins", small)
        self.register_buffer("large_bins", large)

    @property
    def n_packed(self) -> int:
        return self.idx.numel()

    @property
    def n_unique(self) -> int:
        return self.layout.n_unique


def _check_cuda(t, index, n_rows, what):
    native.require_cuda(t, what, torch.float32, t.ndim in (1, 2) and t.shape[0] == n_rows)
    if index.idx.device != t.device:
        raise ValueError(f"{what}: index on {index.idx.device}, values on {t.device}")


def expand_gather_plain(tab, index: ExpandIndex):
    """Plain version of K1: ``tab[idx]``."""
    return tab.index_select(0, index.idx)


def expand_segment_sum_plain(cot, index: ExpandIndex):
    """Plain version of K2: ``index_add_`` of ``cot`` over the bins."""
    out = cot.new_zeros((index.n_unique,) + tuple(cot.shape[1:]))
    return out.index_add_(0, index.idx, cot)


def expand_gather(tab, index: ExpandIndex):
    """K1: ``(U,)`` or ``(U, B)`` table -> ``(P,)`` or ``(P, B)``."""
    if tab.device.type == "cpu":
        return expand_gather_plain(tab, index)
    _check_cuda(tab, index, index.n_unique, "expand_gather")
    B = 1 if tab.ndim == 1 else tab.shape[1]
    out = torch.empty((index.n_packed,) + tuple(tab.shape[1:]), dtype=tab.dtype, device=tab.device)
    err = native.lib().nt_expand_gather(
        tab.data_ptr(), index.idx.data_ptr(), out.data_ptr(), index.n_packed, B,
        native.stream_of(tab),
    )
    native.check(err, "expand_gather")
    native.launches["expand_gather"] += 1
    return out


def expand_segment_sum(cot, index: ExpandIndex):
    """K2: ``(P,)`` or ``(P, B)`` cotangent -> ``(U,)`` or ``(U, B)``."""
    if cot.device.type == "cpu":
        return expand_segment_sum_plain(cot, index)
    _check_cuda(cot, index, index.n_packed, "expand_segment_sum")
    B = 1 if cot.ndim == 1 else cot.shape[1]
    out = torch.empty((index.n_unique,) + tuple(cot.shape[1:]), dtype=cot.dtype, device=cot.device)
    err = native.lib().nt_expand_segment_sum(
        cot.data_ptr(), index.perm.data_ptr(), index.offsets.data_ptr(),
        index.small_bins.data_ptr(), index.small_bins.numel(),
        index.large_bins.data_ptr(), index.large_bins.numel(),
        out.data_ptr(), B, native.stream_of(cot),
    )
    native.check(err, "expand_segment_sum")
    native.launches["expand_segment_sum"] += 1
    return out
