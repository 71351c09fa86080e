"""The 2-D Hartley transform on the card: kernels K3 (rows) and K4 (columns).

Replaces the Pallas pair ``nifty_tpu/ops/pallas_fft.py:_p1`` (K3) and
``:_p2`` (K4).  The TPU pair ran a four-step DFT as bf16x3 matmuls on the
MXU; here both passes are mixed-radix FFTs in shared memory
(``csrc/hartley.cu``, whose header says what bounds them on the card and
how the design answers it):

- K3 :func:`hartley_rows`: real ``(n0, n1)`` -> the row half spectra
  ``(n0, n1/2 + 1)`` complex64, two real rows per complex FFT;
- K4 :func:`hartley_cols`: column FFT of the half spectrum with the
  hermitian fold fused into the store -> real ``(n0, n1)``
  ``H = Re F - Im F``.

The kernels take f32 arrays whose axes are multiples of 256 (the domain of
``pallas_hartley_supported``), 7-smooth and at most ``MAX_AXIS`` long
(one column must fit in a block's shared memory).  Each wrapper runs its
plain PyTorch version when its tensor lies on the CPU; for a CUDA tensor
it launches its kernel or raises.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import native

__all__ = [
    "Hartley2d",
    "cuda_hartley_supported",
    "hartley2d",
    "hartley_cols",
    "hartley_cols_plain",
    "hartley_rows",
    "hartley_rows_plain",
]

MAX_AXIS = 24576  # one padded column of complex64 in <= 200 KiB of shared memory
# launch shape, from a sweep on an H100 80GB HBM3 at 700 W (PERF.md):
# K4 is fastest with 1024 threads on the widest tile of columns that fits
# 176 KiB; K3 with 256 threads up to 4096-point rows and 512 above
_COL_THREADS = 1024
_COL_TILE_BYTES = 176 * 1024


@functools.lru_cache(maxsize=None)
def radix_plan(n: int):
    """Radices (4s first, then 2, 3, 5, 7) whose product is ``n``, or
    None when ``n`` has a prime factor above 7."""
    rads = []
    m = n
    while m % 4 == 0:
        rads.append(4)
        m //= 4
    for r in (2, 3, 5, 7):
        while m % r == 0:
            rads.append(r)
            m //= r
    return tuple(rads) if m == 1 and n > 1 else None


@functools.lru_cache(maxsize=None)
def dit_input_order(n: int) -> np.ndarray:
    """``order[pos]``: the input index that the in-place decimation-in-time
    FFT of ``radix_plan(n)`` expects at position ``pos``.  The last stage
    combines R sub-DFTs held in consecutive blocks, block r being the
    sub-DFT of the inputs ``r, r + R, r + 2R, ...``; recursively so."""
    rads = radix_plan(n)

    def order(seq, stages):
        if not stages:
            return seq
        R = stages[-1]
        return np.concatenate([order(seq[r::R], stages[:-1]) for r in range(R)])

    return order(np.arange(n), rads)


@functools.lru_cache(maxsize=None)
def _fft_tables(n: int, device: str):
    """(twiddles exp(-2 pi i j / n) as complex64 built in double,
    inverse input order as int32, radices) for length ``n`` on ``device``."""
    tw = np.exp(-2j * np.pi * np.arange(n) / n).astype(np.complex64)
    iperm = np.empty(n, np.int32)
    iperm[dit_input_order(n)] = np.arange(n, dtype=np.int32)
    return (
        torch.from_numpy(tw).to(device),
        torch.from_numpy(iperm).to(device),
        radix_plan(n),
    )


def column_bytes(n: int) -> int:
    """Shared memory of one length-``n`` column in the kernels: complex64
    with one element of padding every 32 and every 1024 (``pad`` in
    ``csrc/hartley.cu``)."""
    return (n + (n >> 5) + (n >> 10) + 1) * 8


def row_threads(n1: int) -> int:
    """Threads per K3 block (one block per pair of rows)."""
    return 256 if n1 <= 4096 else 512


def column_tile(n0: int) -> int:
    """Half-spectrum columns per K4 block: a power of two <= 8 whose tile
    fits ``_COL_TILE_BYTES`` of shared memory, at least 1."""
    tc = 8
    while tc > 1 and tc * column_bytes(n0) > _COL_TILE_BYTES:
        tc //= 2
    return tc


def cuda_hartley_supported(shape, dtype) -> bool:
    """Whether K3 + K4 take a real array of this shape and dtype."""
    return (
        len(shape) == 2
        and dtype == torch.float32
        and all(
            n % 256 == 0 and n <= MAX_AXIS and radix_plan(n) is not None
            for n in shape
        )
    )


def hartley_rows_plain(x):
    """Plain version of K3: the row real FFT, ``(n0, n1/2 + 1)`` complex."""
    return torch.fft.rfft(x, dim=-1)


def hartley_cols_plain(G, n1: int):
    """Plain version of K4: column FFT of the half spectrum ``G`` and the
    hermitian fold to the full ``(n0, n1)`` Hartley array."""
    C = torch.fft.fft(G, dim=0)
    n0 = C.shape[0]
    left = C.real - C.imag
    neg = (-torch.arange(n0, device=G.device)) % n0
    right = (C.real + C.imag).index_select(0, neg)[:, 1 : n1 // 2]
    return torch.cat([left, right.flip(1)], dim=1)


def hartley_rows(x):
    """K3: real ``(n0, n1)`` -> row half spectra ``(n0, n1/2 + 1)``."""
    if x.device.type == "cpu":
        return hartley_rows_plain(x)
    native.require_cuda(x, "hartley_rows", torch.float32, cuda_hartley_supported(x.shape, x.dtype))
    n0, n1 = x.shape
    G = torch.empty((n0, n1 // 2 + 1), dtype=torch.complex64, device=x.device)
    tw, iperm, rads = _fft_tables(n1, str(x.device))
    err = native.lib().nt_hartley_rows(
        x.data_ptr(), G.data_ptr(), n0, n1, tw.data_ptr(), iperm.data_ptr(),
        native.int_array(rads), len(rads), row_threads(n1), native.stream_of(x),
    )
    native.check(err, "hartley_rows")
    native.launches["hartley_rows"] += 1
    return G


def hartley_cols(G, n1: int):
    """K4: half spectra ``(n0, n1/2 + 1)`` -> Hartley array ``(n0, n1)``."""
    if G.device.type == "cpu":
        return hartley_cols_plain(G, n1)
    n0 = G.shape[0]
    ok = (
        G.ndim == 2
        and G.shape[1] == n1 // 2 + 1
        and cuda_hartley_supported((n0, n1), torch.float32)
    )
    native.require_cuda(G, "hartley_cols", torch.complex64, ok)
    H = torch.empty((n0, n1), dtype=torch.float32, device=G.device)
    tw, iperm, rads = _fft_tables(n0, str(G.device))
    err = native.lib().nt_hartley_cols(
        G.data_ptr(), H.data_ptr(), n0, n1, column_tile(n0), tw.data_ptr(),
        iperm.data_ptr(), native.int_array(rads), len(rads), _COL_THREADS,
        native.stream_of(G),
    )
    native.check(err, "hartley_cols")
    native.launches["hartley_cols"] += 1
    return H


def hartley2d(x):
    """Unnormalised 2-D Hartley transform ``Re F - Im F`` of a real array,
    through K3 then K4 (their plain versions for a CPU tensor)."""
    return hartley_cols(hartley_rows(x), x.shape[1])


class Hartley2d(torch.autograd.Function):
    """The 2-D Hartley as a differentiable linear map: H is symmetric
    (Hᵀ = H), so its backward and its jvp are the transform itself."""

    @staticmethod
    def forward(x):
        return hartley2d(x.contiguous())

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, grad):
        return Hartley2d.apply(grad)

    @staticmethod
    def jvp(ctx, tangent):
        # through apply: torch.func.jvp passes a wrapped tangent, which has
        # no data pointer; apply hands forward a plain tensor
        return Hartley2d.apply(tangent)
