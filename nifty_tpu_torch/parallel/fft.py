"""Distributed FFT and Hartley transforms of a row-sharded field
(counterpart of ``nifty_tpu/parallel/fft.py``).

Each rank holds rows ``[r n0/p, (r + 1) n0/p)`` of the field's leading
axis.  The transforms are pencil transforms with two explicit exchanges
(``all_to_all_single`` over the field axis's group), never gathers:

- :func:`sharded_fftn` (complex, as the JAX package's): the local FFT over
  the trailing axes, the exchange that splits axis 1, the FFT over axis
  0, the exchange back;
- :func:`sharded_hartley2` / :func:`sharded_hartley`: a real transform from
  the start (no cast to complex), in three per-rank stages that
  :func:`pencil_stages` names so the tests can compose them over virtual
  ranks in one process.

The 2-D Hartley: (1) the rows' real FFT, the half spectrum ``(rows, n1/2 +
1)``; each rank takes the half-spectrum columns ``[c_r, c_{r+1})`` (the
host-local slice of ``n1/2``) and one column more, ``c_{r+1}``, the halo
(the last rank's is the Nyquist column); (2) the column FFT over all n0
rows and the hermitian fold, packed ``(n0, 2 k)``: Hartley columns ``c_r
.. c_{r+1} - 1`` and the mirrors ``n1 - c`` of ``c_r < c <= c_{r+1}``;
(3) the rows back and their columns in place.  Where ``n1 / 2`` splits
evenly, ``w = n1 / 2p`` columns a rank, each exchange moves one packed
buffer (:func:`~.collectives.exchange`): stage 1 writes ``(p, B, rows,
w + pad)`` (chunk ``s`` for rank ``s``: its columns and the halo), stage 2
takes the receive buffer as it is, sender-major, and gives ``(p, B,
rows, 2w)``, destination-major, the return exchange's send buffer.  A
float32 grid in the kernels' domain (``cuda_fft.cuda_hartley_supported``)
runs K3 on the rank's rows and K4r (``cuda_fft.hartley_cols_range``) on
the receive buffer in place (pad 8: K4r's tiles), writing the send
buffer; it needs ``n1 % 16 p == 0`` and an even row count a rank, and any
other ``p`` is refused (:func:`uses_kernels`).  Every other shape and
dtype takes the same stages through ``torch.fft`` (pad 1; uneven splits
as lists of chunks).  The stages also take lists of chunks (the virtual
ranks of the tests), which they stack into the buffer.
More axes: the trailing FFTs (the last one real), the exchange splitting
axis 1 (its blocks of ``n1 / p``), the FFT over axis 0, and a fold in
which each rank writes the columns it transformed and the mirror
images ``(-k0, -k1, .., n - k_last)`` of them, placed by index on the
receiving rank.  1-D fields gather (as the JAX package does).

The Hartley is symmetric: :class:`PencilHartley` is its own adjoint and
its own jvp, and its vmap rule folds a leading sample batch into K3's rows
and K4r's launch grid (one exchange per batch).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..ops import cuda_fft
from ..ops.fft import hartley
from .collectives import all_to_all, exchange
from .mesh import gather_axis
from .multihost import host_local_slice

__all__ = [
    "MeshAxis",
    "PencilHartley",
    "fft_stages",
    "mesh_axis",
    "pencil_stages",
    "sharded_fft2",
    "sharded_fftn",
    "sharded_hartley",
    "sharded_hartley2",
]


class MeshAxis(NamedTuple):
    """A mesh axis as the collectives use it: its group, its size and this
    rank's place on it."""

    group: object
    size: int
    rank: int


def mesh_axis(mesh, axis_name: str = "fx") -> MeshAxis:
    """The :class:`MeshAxis` of ``axis_name`` on ``mesh`` (a ``DeviceMesh``)."""
    return MeshAxis(mesh.get_group(axis_name), mesh.size(mesh.mesh_dim_names.index(axis_name)),
                     mesh.get_local_rank(axis_name))


def uses_kernels(full_shape, p: int, dtype) -> bool:
    """Whether the 2-D pencil Hartley of a ``full_shape`` field over ``p``
    ranks runs K3 + K4r (on a card; their plain versions on the CPU): a
    float32 grid in their domain.  Raises ``ValueError`` for such a grid
    whose ``p`` breaks their layout (``n1 % 16 p``: K4r's 8-column tiles;
    an even row count a rank: K3's row pairs) rather than give way to
    ``torch.fft``."""
    if len(full_shape) != 2 or not cuda_fft.cuda_hartley_supported(tuple(full_shape), dtype):
        return False
    n0, n1 = (int(n) for n in full_shape)
    if n0 % p or n1 % (16 * p) or (n0 // p) % 2:
        raise ValueError(
            f"a float32 {n0}x{n1} field over {p} ranks: K3 + K4r need n1 % (16 p) == 0"
            " and an even number of rows a rank")
    return True


class _Plan2(NamedTuple):
    n0: int
    n1: int
    p: int
    bounds: tuple  # c_0 .. c_p: the ranks' half-spectrum columns
    kernels: bool
    w: Optional[int]  # columns a rank where they split evenly: the buffers' layout


class _PlanN(NamedTuple):
    shape: tuple
    p: int


def _plan(full_shape, p, dtype):
    full_shape = tuple(int(n) for n in full_shape)
    if full_shape[0] % p:
        raise ValueError(f"the leading axis of {full_shape} does not split over {p} ranks")
    if len(full_shape) == 2:
        n0, n1 = full_shape
        if n1 // 2 < p:
            raise ValueError(f"{n1 // 2} half-spectrum columns cannot split over {p} ranks")
        bounds = tuple(host_local_slice(n1 // 2, count=p, index=s)[0] for s in range(p)) + (n1 // 2,)
        even = n1 % (2 * p) == 0
        return _Plan2(n0, n1, p, bounds, uses_kernels(full_shape, p, dtype), n1 // (2 * p) if even else None)
    if full_shape[1] % p:
        raise ValueError(f"axis 1 of {full_shape} does not split over {p} ranks")
    return _PlanN(full_shape, p)


# -- the 2-D stages -------------------------------------------------------------


def _rows2(x, pl: _Plan2):
    """Stage 1: the rows' half spectra, cut into each rank's columns and
    halo: the send buffer ``(p, B, rows, w + pad)``, or (uneven) a list."""
    B, rows, n1 = x.shape
    c = pl.bounds
    if pl.kernels:
        G = cuda_fft.hartley_rows(x.contiguous())  # (B, rows, n1/2 + 1) in padded rows
        if G.stride(-2) != cuda_fft.half_spectrum_pitch(n1):  # the plain version's (a CPU tensor)
            G = cuda_fft.padded_half_spectrum(G)
    else:
        G = torch.fft.rfft(x, dim=-1)
    if pl.w is None:
        return [G[..., c[s] : c[s + 1] + 1] for s in range(pl.p)]
    width = pl.w + (8 if pl.kernels else 1)
    st = G.stride()
    # chunk s: columns s w .. s w + width - 1, overlapping the next by the halo
    return torch.as_strided(G, (pl.p, B, rows, width), (pl.w,) + st, G.storage_offset()).contiguous()


def _cols2(blocks, pl: _Plan2, rank: int):
    """Stage 2 on rank ``rank``: its column block over all rows, folded and
    cut into the ranks' rows: from the receive buffer ``(p, B, rows, w +
    pad)`` (a list of chunks is stacked into it) to the send buffer ``(p,
    B, rows, 2w)``, or (uneven) between lists."""
    if pl.w is not None:
        buf = blocks if torch.is_tensor(blocks) else torch.stack(list(blocks))
        if pl.kernels:  # K4r in place
            return cuda_fft.hartley_cols_range(buf, pl.w, n1=pl.n1)
        return cuda_fft.hartley_cols_range_plain(buf, pl.w)
    blk = torch.cat(list(blocks), dim=1)  # (B, n0, k + 1)
    k = pl.bounds[rank + 1] - pl.bounds[rank]
    P = cuda_fft.hartley_cols_range_plain(blk, k)
    if rank == pl.p - 1 and pl.n1 % 2:  # odd n1: the last column is no column's mirror
        C = torch.fft.fft(blk[..., k : k + 1], dim=-2)
        P = torch.cat([P[..., :k], C.real - C.imag, P[..., k:]], dim=-1)
    return list(P.split(pl.n0 // pl.p, dim=1))


def _place2(packed, pl: _Plan2, rank: int):
    """Stage 3: the rank's rows of every block (the receive buffer ``(p, B,
    rows, 2w)``, or a list), their columns in place."""
    B, rows = packed[0].shape[:2]
    out = packed[0].new_empty((B, rows, pl.n1))
    c = pl.bounds
    for s, P in enumerate(packed):
        k = c[s + 1] - c[s]
        nl = P.shape[-1] - k
        out[..., c[s] : c[s] + nl] = P[..., :nl]
        out[..., pl.n1 - c[s + 1] : pl.n1 - c[s]] = P[..., nl:]
    return out


# -- more axes --------------------------------------------------------------------


def _rowsN(x, pl: _PlanN):
    nd = len(pl.shape)
    F = torch.fft.rfft(x, dim=-1)
    if nd > 2:
        F = torch.fft.fftn(F, dim=tuple(range(2, nd)))  # axes 1 .. d-2 of the field
    b1 = pl.shape[1] // pl.p
    return [F[:, :, s * b1 : (s + 1) * b1] for s in range(pl.p)]


def _neg(n, device):
    return (-torch.arange(n, device=device)) % n


def _colsN(blocks, pl: _PlanN, rank: int):
    nd, nl = len(pl.shape), pl.shape[-1]
    C = torch.fft.fft(torch.cat(blocks, dim=1), dim=1)  # (B, n0, b1, .., n_last/2 + 1)
    left = C.real - C.imag
    right = (C.real + C.imag)[..., 1 : (nl + 1) // 2].flip(-1)
    right = right.index_select(1, _neg(pl.shape[0], C.device))
    for a in range(2, nd - 1):  # the middle axes
        right = right.index_select(a + 1, _neg(pl.shape[a], C.device))
    P = torch.cat([left, right], dim=-1)  # axis 1 of `right` is placed by index
    return list(P.split(pl.shape[0] // pl.p, dim=1))


def _placeN(packed, pl: _PlanN, rank: int):
    n1, nl = pl.shape[1], pl.shape[-1]
    hl = nl // 2 + 1
    left = torch.cat([P[..., :hl] for P in packed], dim=2)
    right = torch.cat([P[..., hl:] for P in packed], dim=2)  # at k1: the column of -k1
    out = left.new_empty(tuple(left.shape[:-1]) + (nl,))
    out[..., :hl] = left
    out[..., hl:] = right.index_select(2, _neg(n1, out.device))
    return out


def pencil_stages(full_shape, p: int, dtype):
    """``(rows, cols, place)``: the per-rank stages of the pencil Hartley of
    a ``full_shape`` field over ``p`` ranks.  ``rows(x)`` of the rank's
    rows ``x`` (a leading batch axis, then the field's) gives the chunk for
    each rank; ``cols(chunks, rank)`` of the chunks a rank received (in
    the senders' order) gives the chunk for each rank; ``place(chunks,
    rank)`` of those received gives the rank's rows of the transform.
    Where the 2-D columns split evenly the chunks are one packed buffer,
    chunk ``s`` along its leading axis (stages 2 and 3 take the exchange's
    buffer, or a list of chunks)."""
    pl = _plan(full_shape, p, dtype)
    if isinstance(pl, _Plan2):
        return (lambda x: _rows2(x, pl)), (lambda b, r: _cols2(b, pl, r)), (lambda b, r: _place2(b, pl, r))
    return (lambda x: _rowsN(x, pl)), (lambda b, r: _colsN(b, pl, r)), (lambda b, r: _placeN(b, pl, r))


def _pencil_hartley(x, ax: MeshAxis, nd: int):
    """The Hartley of the row-sharded field whose rank-local rows are the
    trailing ``nd`` axes of ``x`` (leading axes a batch)."""
    field = tuple(x.shape[x.ndim - nd :])
    batch = tuple(x.shape[: x.ndim - nd])
    full = (field[0] * ax.size,) + field[1:]
    if nd == 1:  # gathered: a 1-D FFT does not split into pencils
        xb = x.reshape((-1,) + field)
        whole = gather_axis(xb, 1, ax.group)
        out = hartley(whole, axes=(1,)).narrow(1, ax.rank * field[0], field[0])
        return out.reshape(x.shape)
    rows, cols, place = pencil_stages(full, ax.size, x.dtype)
    xb = x.reshape((-1,) + field)
    sent = rows(xb)
    if torch.is_tensor(sent):  # the buffers' layout: one packed buffer each way
        back = exchange(cols(exchange(sent, ax.group), ax.rank), ax.group)
        return place(back, ax.rank).reshape(batch + field)
    # every sender holds as many rows, so this rank receives its own chunk's shape p times
    got = all_to_all(sent, [tuple(sent[ax.rank].shape)] * ax.size, ax.group)
    packed = cols(got, ax.rank)
    back = all_to_all(packed, _back_shapes(packed, ax, full, x.dtype, xb.shape[0]), ax.group)
    return place(back, ax.rank).reshape(batch + field)


def _back_shapes(packed, ax, full, dtype, B):
    """The shapes of the chunks this rank receives in stage 2: its rows of
    each rank's packed columns (their widths follow from the plan)."""
    pl = _plan(full, ax.size, dtype)
    rows = full[0] // ax.size
    if isinstance(pl, _Plan2):
        widths = []
        for s in range(ax.size):
            k = pl.bounds[s + 1] - pl.bounds[s]
            widths.append(2 * k + int(s == ax.size - 1 and pl.n1 % 2))
        return [(B, rows, wd) for wd in widths]
    return [tuple(packed[0].shape)] * ax.size


class PencilHartley(torch.autograd.Function):
    """The Hartley of a row-sharded field over its ``nd`` trailing axes
    (leading axes a batch) as a differentiable linear map: symmetric, so
    its backward and its jvp are the transform itself; under
    ``torch.func.vmap`` the mapped axis joins the batch (one exchange and,
    on the card, one K3 and one K4r launch for the whole batch)."""

    @staticmethod
    def forward(x, ax, nd):
        return _pencil_hartley(x, ax, nd)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.ax, ctx.nd = inputs[1], inputs[2]

    @staticmethod
    def backward(ctx, grad):
        return PencilHartley.apply(grad, ctx.ax, ctx.nd), None, None

    @staticmethod
    def jvp(ctx, tangent, *_):
        return PencilHartley.apply(tangent, ctx.ax, ctx.nd)

    @staticmethod
    def vmap(info, in_dims, x, ax, nd):
        return PencilHartley.apply(x.movedim(in_dims[0], 0), ax, nd), 0


def _axis(mesh, axis_name):
    return mesh if isinstance(mesh, MeshAxis) else mesh_axis(mesh, axis_name)


def sharded_hartley(x, mesh, axis_name: str = "fx"):
    """The Hartley transform ``Re F - Im F`` over all axes of the field
    whose rank-local rows are ``x`` (its leading axis split over
    ``axis_name`` of ``mesh``); returns the rank's rows of it.  A 1-D field
    is gathered and transformed whole."""
    return PencilHartley.apply(x, _axis(mesh, axis_name), x.ndim)


def sharded_hartley2(x, mesh, axis_name: str = "fx"):
    """:func:`sharded_hartley` of a 2-D field."""
    if x.ndim != 2:
        raise ValueError("sharded_hartley2 expects a 2-D array")
    return sharded_hartley(x, mesh, axis_name)


def fft_stages(full_shape, p: int, *, inverse: bool = False):
    """``(rows, cols, place)``: the per-rank stages of :func:`sharded_fftn`
    of a ``full_shape`` field over ``p`` ranks, as :func:`pencil_stages`
    (no batch axis)."""
    full_shape = tuple(int(n) for n in full_shape)
    if len(full_shape) < 2:
        raise ValueError("sharded_fftn expects ndim >= 2 (pencil split)")
    if full_shape[0] % p or full_shape[1] % p:
        raise ValueError(f"the two leading axes of {full_shape} do not split over {p} ranks")
    fft = torch.fft.ifftn if inverse else torch.fft.fftn
    b0, b1 = full_shape[0] // p, full_shape[1] // p

    def rows(x):
        y = fft(x, dim=tuple(range(1, x.ndim)))
        return [y[:, s * b1 : (s + 1) * b1] for s in range(p)]

    def cols(blocks, rank):
        return list(fft(torch.cat(blocks, dim=0), dim=(0,)).split(b0, dim=0))

    def place(blocks, rank):
        return torch.cat(blocks, dim=1)

    return rows, cols, place


def sharded_fftn(x, mesh, axis_name: str = "fx", *, inverse: bool = False):
    """The N-D FFT (``inverse``: the inverse FFT) of the field whose
    rank-local rows are ``x`` (ndim >= 2): the local FFT over axes 1.., the
    exchange that splits axis 1, the FFT over axis 0 and the exchange back;
    returns the rank's rows.  The two leading axes must split over the
    axis's ranks."""
    ax = _axis(mesh, axis_name)
    if x.ndim < 2:
        raise ValueError("sharded_fftn expects ndim >= 2 (pencil split)")
    rows, cols, place = fft_stages((x.shape[0] * ax.size,) + tuple(x.shape[1:]), ax.size,
                                   inverse=inverse)
    sent = rows(x)
    shape = tuple(sent[0].shape)
    got = all_to_all(sent, [shape] * ax.size, ax.group)
    return place(all_to_all(cols(got, ax.rank), [shape] * ax.size, ax.group), ax.rank)


def sharded_fft2(x, mesh, axis_name: str = "fx", *, inverse: bool = False):
    """:func:`sharded_fftn` of a 2-D field."""
    if x.ndim != 2:
        raise ValueError("sharded_fft2 expects a 2-D array")
    return sharded_fftn(x, mesh, axis_name, inverse=inverse)
