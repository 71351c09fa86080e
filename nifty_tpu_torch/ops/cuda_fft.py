"""The 2-D Hartley transform on the card: kernels K3 (rows) and K4 (columns).

Replaces the Pallas pair ``nifty_tpu/ops/pallas_fft.py:_p1`` (K3) and
``:_p2`` (K4).  The TPU pair ran a four-step DFT as bf16x3 matmuls on the
MXU.  Here both passes are in-place mixed-radix FFTs whose butterflies
run in registers, with shared memory only for the exchange between passes
(``csrc/hartley.cu``; its header says what bounds them on the card and
how the design answers it):

- K3 :func:`hartley_rows`: real ``(n0, n1)`` -> the row half spectra
  ``(n0, n1/2 + 1)`` complex64, two real rows per complex FFT, written
  with the padded row pitch :func:`half_spectrum_pitch` (a multiple of 8
  complex, so every row starts on a 64-byte boundary); the wrapper returns
  the ``(n0, n1/2 + 1)`` view of that buffer;
- K4 :func:`hartley_cols`: column FFT of such a half spectrum, read in
  16-byte ``cp.async`` copies along its row pitch, with the hermitian fold
  fused into the store -> real ``(n0, n1)`` ``H = Re F - Im F``; by
  clusters of 2 or 4 blocks over 8 columns, each block a part of the rows,
  after a radix-2 or -4 pass across the cluster.

The host side of the design lives here, where the CPU tests reach it:
the decimation-in-frequency pass schedule :func:`fft_plan` (the odd
radices 3, 5, 7 first, then the rest of the power of two as one radix-8,
-4 or -2 pass, then radix 16; each pass with its stride, the magic
multiplier for the division by the stride and its twiddle stride), the
digit-reversed order of its output :func:`output_order`, the padded
shared-memory position :func:`smem_pos`, the two twiddle tables
:func:`twiddle_tables` and the launch shapes :func:`row_launch` /
:func:`col_launch`.

K4r :func:`hartley_cols_range` is K4 on a block of half-spectrum columns
``c .. c + w`` (``w`` a multiple of 8) over all rows, for the pencil
transform of a row-sharded field (:mod:`..parallel.fft`): it writes the
block's Hartley columns ``c .. c + w - 1`` and their mirrors packed as
``(n0, 2w)``, the last column of the block (the halo) only for its mirror.
On the exchange's buffers it reads the block where the receive buffer
holds it, ``(p, B, n0/p, w + 8)`` sender-major, and writes the return
exchange's send buffer, ``(p, B, n0/p, 2w)`` destination-major, so the
pencil transform joins and cuts nothing around it; its launch shape
(:func:`range_launch`) follows the block's tiles.

The kernels take f32 arrays whose axes are multiples of 256 (the domain of
``pallas_hartley_supported``), 7-smooth and at most ``MAX_AXIS`` long
(one padded column must fit in a block's shared memory).  Each wrapper
runs its plain PyTorch version when its tensor lies on the CPU; for a
CUDA tensor it launches its kernel or raises.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import native

__all__ = [
    "Hartley2d",
    "col_launch",
    "col_smem_bytes",
    "cuda_hartley_supported",
    "fft_plan",
    "half_spectrum_pitch",
    "hartley2d",
    "hartley_cols",
    "hartley_cols_plain",
    "hartley_cols_range",
    "hartley_cols_range_plain",
    "hartley_rows",
    "hartley_rows_plain",
    "output_order",
    "padded_half_spectrum",
    "radix_plan",
    "range_launch",
    "row_launch",
    "row_smem_bytes",
    "smem_pos",
    "twiddle_tables",
]

MAX_AXIS = 24576  # one padded column of complex64 (209 KB) in a block's shared memory
SMEM_LIMIT = 232448  # shared memory a block may use on sm_90 (227 KB)
TW_LO = 128  # entries of the low twiddle table: w^m = hi[m >> 7] * lo[m & 127]
MAX_THREADS = 640  # the kernels' launch bound (kMaxThreads in csrc/hartley.cu)
MAX_THREADS_WIDE = 288  # that of the clusters of 8 and 16 blocks (kMaxThreadsWide)
CLUSTERS = (2, 4, 8, 16)  # the cluster kernel's sizes (16: past the portable size)
# Launch shapes (row_launch, col_launch), from sweeps on an NVIDIA H100
# 80GB HBM3 at 700 W (nifty_tpu_torch/bench/hartley_bench.py --sweep;
# PERF.md): K3 fastest with n1/16 threads a row pair up to 2048 points,
# 128 up to 4096, 256 above; K4 with the widest tile of columns that fits
# (clusters over 8 columns: 2 blocks up to 2048 rows, 4 above) and 32
# threads a column up to 2048 rows a block, 64 above.


@functools.lru_cache(maxsize=None)
def radix_plan(n: int):
    """Radices of the pass schedule of a length-``n`` FFT: the odd radices
    3, 5, 7, then the power of two beyond a multiple of 4 bits as one radix
    8, 4 or 2, then 16 for every 4 bits; None when ``n`` has a prime
    factor above 7."""
    if n < 2:
        return None
    m, a = n, 0
    while m % 2 == 0:
        m //= 2
        a += 1
    rads = []
    for r in (3, 5, 7):
        while m % r == 0:
            rads.append(r)
            m //= r
    rads += ([2 ** (a % 4)] if a % 4 else []) + [16] * (a // 4)
    return tuple(rads) if m == 1 else None


@functools.lru_cache(maxsize=None)
def fft_plan(n: int, table_len: int = 0):
    """The in-place decimation-in-frequency passes of a length-``n`` FFT, as
    ``(R, m, magic, tw_stride)``: pass radix; m, the stride of a
    butterfly's elements (the block length L left by the passes before it,
    over R); the multiplier with ``j // m == (j * magic) >> 32`` (0 when
    m = 1); and ``table_len // L``, the step of the twiddle index
    ``q k tw_stride`` into the twiddle tables of length ``table_len``
    (default n)."""
    rads = radix_plan(n)
    if rads is None:
        return None
    table_len = table_len or n
    out, L = [], n
    for R in rads:
        m = L // R
        out.append((R, m, 0 if m == 1 else -(-(1 << 32) // m), table_len // L))
        L = m
    return tuple(out)


@functools.lru_cache(maxsize=None)
def output_order(n: int) -> np.ndarray:
    """``pos[f]``: where the passes of :func:`fft_plan` leave frequency f
    (digit reversal: f = q0 + R0 q1 + R0 R1 q2 + ... lands at
    q0 m0 + q1 m1 + ..., with m the passes' strides), as int16."""
    f = np.arange(n)
    pos = np.zeros(n, np.int64)
    for R, m, _, _ in fft_plan(n):
        pos += (f % R) * m
        f //= R
    return pos.astype(np.int16)


def smem_pos(i):
    """Padded shared-memory position of element ``i`` of a sequence: one
    element of padding every 16 and every 256, so that the stride-16
    accesses of the last pass and the stride-256 reads of the
    digit-reversed output fall on distinct banks (``pad`` in
    ``csrc/hartley.cu``)."""
    return i + (i >> 4) + (i >> 8)


def buffer_len(n: int) -> int:
    """Shared-memory elements (complex64) of one padded length-``n`` sequence."""
    return n + n // 16 + n // 256


def half_spectrum_pitch(n1: int) -> int:
    """Row pitch (complex elements) of the half spectrum K3 writes and K4
    reads: ``n1/2 + 1`` rounded up to a multiple of 8 (64 bytes)."""
    return n1 // 2 + 8


@functools.lru_cache(maxsize=None)
def twiddle_tables(n: int):
    """``(lo, hi)``: ``exp(-2 pi i m / n)`` for ``m < TW_LO`` and for
    ``m = TW_LO h``, ``h < n / TW_LO``, in double (complex128)."""
    lo = np.exp(-2j * np.pi * np.arange(TW_LO) / n)
    hi = np.exp(-2j * np.pi * TW_LO * np.arange(n // TW_LO) / n)
    return lo, hi


def _tables_bytes(n: int) -> int:
    return (TW_LO + n // TW_LO) * 8


def row_smem_bytes(n1: int) -> int:
    """Dynamic shared memory of a K3 block: the twiddle tables and one
    padded complex row (a pair of real rows)."""
    return _tables_bytes(n1) + buffer_len(n1) * 8


def col_smem_bytes(n0: int, tc: int, parts: int) -> int:
    """Dynamic shared memory of a K4 block (see :func:`col_launch`): the
    twiddle tables and a tile of ``tc`` padded columns; in a cluster of
    ``parts`` blocks, one more column (the extra one) and n0 / parts rows of
    each."""
    rows = n0 // parts if parts else n0
    return _tables_bytes(n0) + (tc + (parts > 0)) * buffer_len(rows) * 8


def row_launch(n1: int) -> int:
    """K3 launch shape: threads per block (one pair of rows)."""
    return n1 // 16 if n1 <= 2048 else 128 if n1 <= 4096 else 256


def col_launch(n0: int):
    """K4 launch shape ``(T, tc, parts)``: threads per column, columns per
    tile, and the blocks of a cluster: clusters of ``parts`` blocks over 8
    columns and the extra column c0 + 8 that aligns the mirror stores, each
    block n0 / parts of the rows; 2 up to 2048 rows and 4 above, 32
    threads a column up to 2048 rows a block and 64 above (the fastest in
    the sweep), where they fit (n0 <= 11776); else (parts 0) one block over
    a tile of 2 columns, or 1, with 64 threads a column."""
    parts = 2 if n0 <= 2048 else 4
    T = min(32 if n0 // parts <= 2048 else 64, n0 // 16)
    if 9 * T <= MAX_THREADS and col_smem_bytes(n0, 8, parts) <= SMEM_LIMIT:
        return T, 8, parts
    for tc in (2, 1):
        if col_smem_bytes(n0, tc, 0) <= SMEM_LIMIT:
            return 64, tc, 0
    raise ValueError(f"no K4 launch shape for columns of {n0}")


def _cluster_fits(n0: int, parts: int, T: int) -> bool:
    hn = n0 // parts
    return (n0 % parts == 0 and hn % parts == 0 and hn % 16 == 0 and radix_plan(hn) is not None
            and 1 <= T <= hn // 16 and 9 * T <= (MAX_THREADS_WIDE if parts >= 8 else MAX_THREADS)
            and col_smem_bytes(n0, 8, parts) <= SMEM_LIMIT)


@functools.lru_cache(maxsize=None)
def range_launch(n0: int, w: int, batch: int = 1):
    """K4r launch shape ``(T, tc, parts)`` for a block of ``w`` columns (and
    the halo) over ``n0`` rows, ``batch`` slices, chosen by the block's
    tiles of 8 columns (not by ``n0`` alone; a sweep on an NVIDIA H100
    80GB HBM3 at 700 W, ``bench/sharded_kernels_bench.py --sweep``, PERF.md).
    Between 33 and 132 tiles of at least 2048 rows, clusters of 2 blocks with
    64 threads a column (each block n0/2 rows, one wave of the card's SMs)
    where they fit; at
    most 32 tiles, or more than 8192 rows, clusters of 16; else of 8; each
    with hn/32 threads a column (hn the rows of a block) rounded down to a
    power of 2 in 8 .. 32; the first that fits, else :func:`col_launch`."""
    tiles = w // 8 * batch
    prefs = [(64, 2)] if 32 < tiles <= 132 and n0 >= 2048 else []
    prefs += [(0, 16)] if tiles <= 32 or n0 > 8192 else []
    prefs += [(0, 8), (0, 4), (0, 2)]
    for T, parts in prefs:
        hn = n0 // parts
        T = min(T or min(32, max(8, 1 << max(hn // 32, 1).bit_length() - 1)), hn // 16)
        if _cluster_fits(n0, parts, T):
            return T, 8, parts
    return col_launch(n0)


@functools.lru_cache(maxsize=None)
def _fft_tables(n: int, device: str, parts: int = 1):
    """(twiddle tables lo ‖ hi of length ``n`` as complex64 built in
    double, the output order as int16, the plan as four ints per pass) on
    ``device``; for ``parts`` > 1 the plan and output order of the length
    n / parts transforms that K4's clusters run after their cross pass."""
    lo, hi = twiddle_tables(n)
    tab = np.concatenate([lo, hi]).astype(np.complex64)
    m = n // parts
    plan = [v for p in fft_plan(m, n) for v in p]
    rev = torch.from_numpy(output_order(m))
    return torch.from_numpy(tab).to(device), rev.to(device), plan


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
    """Plain version of K4: column FFT of the half spectrum ``G`` (``(n0,
    n1/2 + 1)``, or a leading batch of them) and the hermitian fold to the
    full ``(n0, n1)`` Hartley array."""
    C = torch.fft.fft(G, dim=-2)
    n0 = C.shape[-2]
    left = C.real - C.imag
    neg = (-torch.arange(n0, device=G.device)) % n0
    right = (C.real + C.imag).index_select(-2, neg)[..., 1 : n1 // 2]
    return torch.cat([left, right.flip(-1)], dim=-1)


def hartley_cols_range_plain(G, w: int):
    """Plain version of K4r: the column FFT of the half-spectrum block ``G``
    (``(n0, >= w + 1)``, or a leading batch of them; columns ``c .. c + w``
    of a half spectrum) folded to ``(n0, 2w)``: column ``t < w`` is the
    Hartley column ``c + t``, column ``2w - t`` (``1 <= t <= w``) the mirror
    column ``n1 - c - t``.  A slice of :func:`hartley_cols_plain`'s output;
    also the pencil Hartley's column stage for the shapes and dtypes
    outside K3 + K4r's domain (``parallel.fft``).  On the exchange's
    layout, ``G`` of ``(p, B, n0/p, >= w + 1)`` (sender-major: rows ``s
    n0/p ..`` of the block from rank ``s``), the result is ``(p, B, n0/p,
    2w)``, destination-major: rows ``d n0/p ..`` for rank ``d``."""
    if G.ndim == 4:
        p, B, rows, width = G.shape
        P = hartley_cols_range_plain(G.movedim(0, 1).reshape(B, p * rows, width), w)
        return P.reshape(B, p, rows, 2 * w).movedim(1, 0).contiguous()
    C = torch.fft.fft(G[..., : w + 1], dim=-2)
    n0 = C.shape[-2]
    left = C.real - C.imag
    neg = (-torch.arange(n0, device=G.device)) % n0
    right = (C.real + C.imag).index_select(-2, neg)[..., 1:]
    return torch.cat([left[..., :w], right.flip(-1)], dim=-1)


def padded_half_spectrum(G):
    """A copy of the half spectrum ``G`` (``(n0, n1/2 + 1)``, or a leading
    batch of them) in the padded row pitch that K4 reads: the view of a
    buffer with rows of :func:`half_spectrum_pitch`, padding zeroed."""
    h = G.shape[-1]
    buf = G.new_zeros(tuple(G.shape[:-1]) + (half_spectrum_pitch(2 * (h - 1)),))
    view = buf[..., :h]
    view.copy_(G)
    return view


def _launch_rows(x, G, threads):
    """Launch K3 with ``threads`` a block on the checked rows ``x`` (``(rows,
    n1)``) into the ``(rows, pitch)`` buffer ``G``; the one place that knows
    its arguments (the launch-shape sweep calls it too, so it counts
    nothing)."""
    rows, n1 = x.shape
    tab, rev, plan = _fft_tables(n1, str(x.device))
    err = native.lib().nt_hartley_rows(
        x.data_ptr(), G.data_ptr(), rows, n1, G.stride(0), tab.data_ptr(), rev.data_ptr(),
        native.int_array(plan), len(plan) // 4, threads, native.stream_of(x),
    )
    native.check(err, "hartley_rows")


def _launch_cols(G, H, T, tc, parts, n1=None, src_col=0, n_cols=0):
    """Launch K4 at the launch shape ``(T, tc, parts)`` (:func:`col_launch`)
    on the checked half spectra ``G`` (``(n0, h)`` or ``(B, n0, h)``) into
    ``H``, one batch index a row of the launch grid; counts nothing, as
    :func:`_launch_rows`.  With ``n_cols`` = w > 0 it is K4r: the columns
    ``src_col .. src_col + w`` of half spectra of width ``n1`` into the
    packed ``(n0, 2w)`` arrays ``H``; on the exchange's layout, ``G`` of
    ``(p, B, n0/p, pitch)`` into ``H`` of ``(p, B, n0/p, 2w)``."""
    if G.ndim == 4:
        chunks, batch, rows, nw = H.shape
        n0, chunk_pitch, batch_pitch = chunks * rows, G.stride(0), G.stride(1)
    else:
        n0, nw = H.shape[-2:]
        chunks, chunk_pitch, batch = 1, 0, H.numel() // (n0 * nw)
        batch_pitch = G.stride(0) if G.ndim == 3 else n0 * G.stride(-2)
    n1 = nw if n1 is None else n1
    tab, rev, plan = _fft_tables(n0, str(G.device), max(parts, 1))
    err = native.lib().nt_hartley_cols(
        G.data_ptr(), H.data_ptr(), n0, n1, G.stride(-2), batch_pitch, chunk_pitch, chunks, batch,
        tab.data_ptr(), rev.data_ptr(), native.int_array(plan), len(plan) // 4, T, tc, parts,
        src_col, n_cols, native.stream_of(G),
    )
    native.check(err, "hartley_cols_range" if n_cols else "hartley_cols")


def hartley_rows(x):
    """K3: real ``(n0, n1)`` -> row half spectra ``(n0, n1/2 + 1)``, a view
    with the row pitch :func:`half_spectrum_pitch`.  A batch ``(B, n0, n1)``
    is ``B n0`` independent rows, one launch; ``n1`` in the kernels' domain,
    the rows any even number."""
    if x.device.type == "cpu":
        return hartley_rows_plain(x)
    # rows pair up into complex FFTs: any even number of them (a rank's
    # rows of a sharded field need not be a multiple of 256)
    native.require_cuda(x, "hartley_rows", torch.float32,
                        x.ndim in (2, 3) and cuda_hartley_supported((256, x.shape[-1]), x.dtype)
                        and (x.numel() // max(x.shape[-1], 1)) % 2 == 0)
    if x.data_ptr() % 16:
        raise ValueError("hartley_rows: tensor must start on a 16-byte boundary")
    n1 = x.shape[-1]
    G = torch.empty(tuple(x.shape[:-1]) + (half_spectrum_pitch(n1),), dtype=torch.complex64,
                    device=x.device)
    _launch_rows(x.view(-1, n1), G.view(-1, G.shape[-1]), row_launch(n1))
    native.launches["hartley_rows"] += 1
    native.batched_launches["hartley_rows"] += x.ndim == 3 and x.shape[0] > 1
    return G[..., : n1 // 2 + 1]


def hartley_cols(G, n1: int):
    """K4: half spectra ``(n0, n1/2 + 1)`` -> Hartley array ``(n0, n1)``; a
    batch ``(B, n0, n1/2 + 1)`` -> ``(B, n0, n1)`` in one launch.  On the
    card ``G`` must have unit column stride, a row pitch that is a multiple
    of 8 complex with room for the last tile and a batch pitch that keeps
    every slice on a 16-byte boundary, as :func:`hartley_rows` and
    :func:`padded_half_spectrum` give it; any other layout raises (no copy
    is made)."""
    if G.device.type == "cpu":
        return hartley_cols_plain(G, n1)
    n0 = G.shape[-2]
    ok = (
        G.ndim in (2, 3)
        and G.shape[-1] == n1 // 2 + 1
        and cuda_hartley_supported((n0, n1), torch.float32)
    )
    if G.device.type != "cuda":
        raise ValueError(f"hartley_cols: tensor on {G.device}; CPU or CUDA expected")
    if G.dtype != torch.complex64:
        raise TypeError(f"hartley_cols: dtype {G.dtype}; torch.complex64 expected")
    if not ok:
        raise ValueError(f"hartley_cols: shape {tuple(G.shape)} outside the kernel's domain")
    T, tc, parts = col_launch(n0)
    pitch = G.stride(-2)
    batch = G.shape[0] if G.ndim == 3 else 1
    batch_pitch = G.stride(0) if G.ndim == 3 else n0 * pitch
    room = G.untyped_storage().nbytes() // 8 - G.storage_offset()
    if (
        G.stride(-1) != 1
        or pitch % 8
        or pitch < n1 // 2 + tc
        or batch_pitch % 8
        or (batch > 1 and batch_pitch < n0 * pitch)
        or room < (batch - 1) * batch_pitch + n0 * pitch
        or G.data_ptr() % 16
    ):
        raise ValueError(
            f"hartley_cols: strides {G.stride()}: K4 reads rows of pitch a multiple of 8 "
            f"complex, at least {n1 // 2 + tc}, from a 16-byte boundary "
            "(the layout of hartley_rows or padded_half_spectrum)"
        )
    H = torch.empty(tuple(G.shape[:-1]) + (n1,), dtype=torch.float32, device=G.device)
    _launch_cols(G, H, T, tc, parts)
    native.launches["hartley_cols"] += 1
    native.batched_launches["hartley_cols"] += batch > 1
    return H


def hartley_cols_range(G, w: int, src_col: int = 0, n1=None):
    """K4r: the half-spectrum columns ``src_col .. src_col + w`` of ``G``
    (``(n0, h)`` or ``(B, n0, h)``, half spectra of width ``n1``, by
    default ``2 (h - 1)``) -> the packed ``(n0, 2w)`` (``(B, n0, 2w)``)
    of :func:`hartley_cols_range_plain`, one launch.  On the exchange's
    layout, ``G`` of ``(p, B, n0/p, h)`` as the receive buffer holds the
    ranks' chunks (``src_col`` 0, ``n1`` given), the result is the return
    exchange's ``(p, B, n0/p, 2w)``, read and written in place.  On the
    card ``w`` and ``src_col`` are multiples of 8 and ``G`` has K4's layout
    (unit column stride, a row pitch a multiple of 8 complex with room for
    the tiles past ``src_col + w``, 16-byte aligned), as :func:`hartley_rows`
    or the exchange gives it; any other layout raises."""
    if G.device.type == "cpu":
        return hartley_cols_range_plain(G[..., src_col:], w)
    exchange = G.ndim == 4
    n0 = G.shape[0] * G.shape[2] if exchange else G.shape[-2]
    n1 = 2 * (G.shape[-1] - 1) if n1 is None else n1
    if G.device.type != "cuda":
        raise ValueError(f"hartley_cols_range: tensor on {G.device}; CPU or CUDA expected")
    if G.dtype != torch.complex64:
        raise TypeError(f"hartley_cols_range: dtype {G.dtype}; torch.complex64 expected")
    ok = (
        G.ndim in (2, 3, 4)
        and cuda_hartley_supported((n0, 256), torch.float32)
        and n1 % 256 == 0
        and w > 0 and w % 8 == 0 and src_col % 8 == 0 and src_col >= 0
        and src_col + w <= n1 // 2
        and G.shape[-1] >= src_col + w + 1
        and not (exchange and src_col)
    )
    if not ok:
        raise ValueError(
            f"hartley_cols_range: shape {tuple(G.shape)}, columns {src_col} + {w} of {n1} "
            "outside the kernel's domain")
    batch = G.shape[1] if exchange else G.shape[0] if G.ndim == 3 else 1
    T, tc, parts = range_launch(n0, w, batch)
    pitch = G.stride(-2)
    if exchange:
        p, rows = G.shape[0], G.shape[2]
        batch_pitch, span = G.stride(1), (p - 1) * G.stride(0) + (batch - 1) * G.stride(1)
        # one chunk (one rank): its pitch is never used, whatever the view says
        layout_ok = p == 1 or (G.stride(0) % 8 == 0
                               and G.stride(0) >= (batch - 1) * batch_pitch + rows * pitch)
        layout_ok = layout_ok and (batch == 1 or batch_pitch >= rows * pitch)
        span += rows * pitch
    else:
        batch_pitch = G.stride(0) if G.ndim == 3 else n0 * pitch
        layout_ok = batch == 1 or batch_pitch >= n0 * pitch
        span = (batch - 1) * batch_pitch + n0 * pitch
    room = G.untyped_storage().nbytes() // 8 - G.storage_offset()
    if (
        not layout_ok
        or G.stride(-1) != 1
        or pitch % 8
        or pitch < src_col + w + (1 if parts else tc)  # a cluster's last tile reads the halo
        or batch_pitch % 8
        or room < span
        or G.data_ptr() % 16
    ):
        raise ValueError(
            f"hartley_cols_range: strides {G.stride()}: K4r reads rows of pitch a multiple of 8 "
            f"complex, at least {src_col + w + (1 if parts else tc)}, from a 16-byte boundary")
    H = torch.empty(tuple(G.shape[:-1]) + (2 * w,), dtype=torch.float32, device=G.device)
    _launch_cols(G, H, T, tc, parts, n1=n1, src_col=src_col, n_cols=w)
    native.launches["hartley_cols_range"] += 1
    native.batched_launches["hartley_cols_range"] += batch > 1
    return H


def hartley2d(x):
    """Unnormalised 2-D Hartley transform ``Re F - Im F`` of a real array
    ``(n0, n1)`` or a batch ``(B, n0, n1)``, through K3 then K4 (their plain
    versions for a CPU tensor)."""
    return hartley_cols(hartley_rows(x), x.shape[-1])


class Hartley2d(torch.autograd.Function):
    """The 2-D Hartley over the trailing two axes as a differentiable linear
    map: H is symmetric (Hᵀ = H), so its backward and its jvp are the
    transform itself.  Leading axes are a batch, and so is the axis that
    ``torch.func.vmap`` maps (moved to the front): one K3 and one K4 launch
    for the whole batch on the card.  On a ``meta`` tensor it returns an
    empty one of the same shape (``model.eval_shape``)."""

    @staticmethod
    def forward(x):
        if x.is_meta:  # shapes only (eval_shape): no launch
            return torch.empty_like(x)
        x = x.contiguous()
        if x.is_cuda and x.data_ptr() % 16:
            x = x.clone()  # K3 loads 16-byte vectors; a fresh buffer is aligned
        if x.ndim == 2:
            return hartley2d(x)
        # a slice of a contiguous batch starts n0 n1 floats (a multiple of
        # 256²) after the previous one, so it stays 16-byte aligned
        return hartley2d(x.reshape((-1,) + tuple(x.shape[-2:]))).reshape(x.shape)

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

    @staticmethod
    def vmap(info, in_dims, x):
        # the mapped axis leads; forward copies it to a contiguous batch
        # when it lay elsewhere (after K1, whose sample axis is last)
        return Hartley2d.apply(x.movedim(in_dims[0], 0)), 0
