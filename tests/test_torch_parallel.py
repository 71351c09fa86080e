"""Port parity: the multi-GPU slice (``nifty_tpu_torch.parallel``, the
field-sharded correlated field, ``optimize_kl(devices=, position_sharding=)``
and ``"pmap"``) against ``nifty_tpu.parallel`` and the JAX package's
unsharded model, on the CPU in float64.

(a) Without processes: the range forms' plain versions (K1r, K2r, K4r)
against slices of the full plain versions, and the pencil transforms'
per-rank stages composed over p virtual ranks against the JAX package's
``sharded_hartley2`` / ``sharded_fft2`` on the conftest's 8-device mesh.
(b) One launch of 2 gloo ranks and one of 4, each over a ``file://``
store: the ranks are subprocesses of the worker script below, which
imports only torch and the port, reads its inputs from numpy files this
module wrote and writes its shards to a file per rank; each test compares
one check.  (c) The refusals and the helpers.

Tolerances, and why: the transforms, the forward and the metric 1e-10
(float64 FFTs and sums in another order); one ``optimize_kl`` iteration
with ``position_sharding=`` against the JAX package's one-device run
1e-4 (the reference's own bound, ``tests/test_parallel.py``: its Newton-CG
amplifies the rounding of reductions in another order); with ``devices=``
against the port's one-process run from the same seeds 1e-8, with CG and
Newton-CG cut to a few steps (as ``test_torch_vi.py``: past that, double
rounding grows without bound on these ill-conditioned systems).
"""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from jax import numpy as jnp
from jax import random

import nifty_tpu as nj
import nifty_tpu_torch as nt
from nifty_tpu.ops.fft import hartley as jax_hartley
from nifty_tpu.parallel.fft import sharded_fft2 as jax_sharded_fft2
from nifty_tpu.parallel.fft import sharded_hartley2 as jax_sharded_hartley2
from nifty_tpu.utils.tree import random_like as jax_random_like
from nifty_tpu_torch import parallel
from nifty_tpu_torch.ops import cuda_expand as ce
from nifty_tpu_torch.ops import cuda_fft
from nifty_tpu_torch.ops.mode_expand import ExpandIndex, _rfp_index_table, build_expand_layout
from nifty_tpu_torch.parallel.fft import fft_stages, pencil_stages, uses_kernels

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-10
SHAPE = (16, 8)  # the reference's (4p, 2p) at p = 4 and its 2 x 2 mesh's grid
SHAPE_3D = (8, 4, 6)
N_SAMPLES = {2: 2, 4: 2}  # sample pairs of the position-sharded runs
CG = dict(absdelta=1e-10, maxiter=100)
KL = dict(xtol=1e-8, maxiter=10)
SHORT_CG = dict(maxiter=5, miniter=5, resnorm=-1.0)
SHORT_KL = dict(maxiter=2, xtol=-1.0, cg_kwargs=SHORT_CG)


def _close(got, want, atol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0, atol=atol * max(np.abs(want).max(), 1.0))


def _rows(a, rank, p, axis=0):
    b = a.shape[axis] // p
    return np.take(a, range(rank * b, (rank + 1) * b), axis=axis)


# --- (a) the range forms and the stages, without processes -----------------------------


def _index(full):
    pd, ml, _ = nt.get_fourier_mode_distributor(full, [1.0 / n for n in full])
    core = pd[tuple(slice(0, n // 2 + 1) for n in full)]
    return ExpandIndex(*build_expand_layout(core, ml.size)), ml.size


@pytest.mark.parametrize("full", [(16, 16), (12, 12), (12, 8, 6)])
@pytest.mark.parametrize("p", [1, 2, 4])
def test_row_range_plain_versions_are_slices(full, p):
    """K1r's plain version is the rows of K1's; K2r's of a rows' cotangent,
    summed over the ranks, is K2's (rfp2 on square grids, flat on 3-D)."""
    index, U = _index(full)
    rng = np.random.default_rng(p)
    tab = torch.from_numpy(rng.standard_normal((U, 3)))
    cot = torch.from_numpy(rng.standard_normal(full + (3,)))
    grid = ce.expand_to_grid_plain(tab, index, full)
    b = full[0] // p
    parts = 0
    for r in range(p):
        rows = (r * b, b)
        assert torch.equal(ce.expand_to_grid_rows(tab, index, full, rows), grid[r * b : (r + 1) * b])
        parts = parts + ce.collapse_from_grid_rows(cot[r * b : (r + 1) * b], index, full, rows)
        assert ce.row_range(full, rows) == (3 - len(full), r * b, b)
    _close(parts.numpy(), ce.collapse_from_grid_plain(cot, index, full).numpy())
    with pytest.raises(ValueError, match="outside"):
        ce.row_range(full, (full[0] - 1, 2))


def _core_points(index):
    """The numpy model of the packed layout: each packed point's core
    coordinates ``(x0, x1, x2)`` (rfp2: its upper-triangle point, through
    the layout's own packing of a symmetric table of point ids)."""
    core = tuple(index.layout.core_shape)
    if index.layout.kind == "rfp2":
        H = core[0]
        a, b = np.meshgrid(np.arange(H), np.arange(H), indexing="ij")
        ids = _rfp_index_table(np.minimum(a, b) * H + np.maximum(a, b)).ravel()
        return np.zeros_like(ids), ids // H, ids % H
    pts = np.unravel_index(np.arange(int(np.prod(core))), core)
    return ((np.zeros_like(pts[0]),) * (3 - len(core))) + pts


def _needed_model(index, full, lo, n):
    """Per packed point: whether a full-grid image lies in rows [lo, lo + n)."""
    c = index.layout.core_shape[0]
    y = np.arange(lo, lo + n)
    R = np.zeros(c, bool)
    R[y if c == full[0] else np.where(y < c, y, full[0] - y)] = True
    x = _core_points(index)
    if index.layout.kind == "rfp2":
        return R[x[1]] | R[x[2]]
    return R[x[3 - len(full)]]


@pytest.mark.parametrize("full", [(16, 16), (12, 12), (12, 8, 6)])
def test_row_range_launch_covers_the_needed_core_rows(full):
    """For every range of rows: ``core_rows`` is the one interval of core
    rows the range's images come from; the launch rows cover it and each
    meets it; the rfp2 kernels' tiles (the kernel's block-to-tile map,
    modelled here) are each launched once, I <= J, exactly those that meet
    the launch rows, and they hold every packed point with an image in the
    range."""
    index, _ = _index(full)
    n0, c = full[0], index.layout.core_shape[0]
    step = ce.TILE if index.layout.kind == "rfp2" else 1
    T = -(-index.layout.core_shape[-1] // ce.TILE)
    x = _core_points(index)
    for lo in range(n0):
        for n in range(1, n0 - lo + 1):
            y = np.arange(lo, lo + n)
            R = set((y if c == n0 else np.where(y < c, y, n0 - y)).tolist())
            s, m = ce.core_rows(n0, c, lo, n)
            assert set(range(s, s + m)) == R
            k_lo, k_n = ce.launch_rows(index.layout, full, (lo, n))
            K = set(range(k_lo, k_lo + k_n))
            assert R <= {r for k in K for r in range(k * step, (k + 1) * step)}
            assert all(R & set(range(k * step, (k + 1) * step)) for k in K)
            if index.layout.kind != "rfp2":
                continue
            tiles = []
            for by in range(k_n):  # tile_of<true>: block (blockIdx.x = X, blockIdx.y = by)
                for X in range(T):
                    K_ = k_lo + by
                    if not (X < K_ and X >= k_lo):
                        tiles.append((min(K_, X), max(K_, X)))
            assert len(tiles) == len(set(tiles))
            assert set(tiles) == {(i, j) for i in range(T) for j in range(i, T) if i in K or j in K}
            need = _needed_model(index, full, lo, n)
            assert {(int(a) // ce.TILE, int(b) // ce.TILE) for a, b in zip(x[1][need], x[2][need])} <= set(tiles)


@pytest.mark.parametrize("full", [(16, 16), (12, 12), (12, 8, 6)])
def test_row_range_csr_sums_match_index_add(full):
    """K2r's range CSR (``ExpandRows``) against a numpy model: the packed
    points with an image in the range, by bin in the index's stable order,
    the bins they touch, their offsets and the large bins; its sums of the
    range's folded cotangent (the plain fold of the rows' cotangent padded
    with zeros) equal ``index_add_`` over every packed point, each other
    point's folded value is 0.  A range with an image of ``DENSE`` of the
    points or more is ``dense`` and keeps no tables.  The tables follow the
    index through ``.to`` (here one that keeps the device) and are kept."""
    index, U = _index(full)
    idx = index.idx.numpy()
    rng = np.random.default_rng(5)
    n0 = full[0]
    ranges = [(0, n0 // 2), (n0 // 2, n0 // 4), (n0 // 2 - 1, 2), (n0 - 1, 1), (3, 1), (0, n0)]
    for lo, n in ranges:
        t = index.row_tables(full, (lo, n))
        assert index.row_tables(full, (lo, n)) is t
        need = _needed_model(index, full, lo, n)
        perm = np.argsort(idx, kind="stable")
        perm = perm[need[perm]]
        assert t.dense == (perm.size >= ce.DENSE * index.n_packed)
        if t.dense:  # K2r takes the index's own CSR: the range keeps none
            assert t.perm.numel() == t.n_bins == t.large_bins.numel() == 0
            continue
        counts = np.bincount(idx[perm], minlength=U)
        bins = np.flatnonzero(counts)
        np.testing.assert_array_equal(t.perm.numpy(), perm)
        np.testing.assert_array_equal(t.bins.numpy(), bins)
        np.testing.assert_array_equal(t.offsets.numpy(), np.concatenate([[0], np.cumsum(counts[bins])]))
        np.testing.assert_array_equal(t.large_bins.numpy(), np.flatnonzero(counts[bins] > ce.LARGE_BIN))
        cot = np.zeros(full + (2,))
        cot[lo:lo + n] = rng.standard_normal((n,) + full[1:] + (2,))
        core = ce.mirror_fold(torch.from_numpy(cot), index.layout.core_shape)
        if index.layout.kind == "rfp2":
            core = torch.movedim(ce._fold_rfp2(torch.movedim(core, -1, 0), index.layout), 0, -1)
        folded = core.reshape(-1, 2).numpy()
        assert not folded[~need].any()
        got = np.zeros((U, 2))
        off = t.offsets.numpy()
        for k, u in enumerate(bins):
            got[u] = folded[perm[off[k]:off[k + 1]]].sum(0)
        want = torch.zeros(U, 2, dtype=torch.float64).index_add_(0, index.idx.long(), torch.from_numpy(folded))
        _close(got, want.numpy())
    index.to(torch.float32)
    assert len(index.ranges) == len(ranges) and index.ranges[next(iter(index.ranges))].perm.dtype == torch.int32


@pytest.mark.parametrize("p", [1, 2, 4, 8])
def test_column_range_plain_version_is_a_slice(p):
    """K4r's plain version on rank r's columns r w .. r w + w (w = n1/2p; the
    last rank's halo the Nyquist column) is H's columns [r w, r w + w) and
    [n1 - r w - w, n1 - r w); over the ranks every column once."""
    n0, n1 = 24, 128
    x = torch.from_numpy(np.random.default_rng(p).standard_normal((2, n0, n1)))
    G = cuda_fft.hartley_rows_plain(x)
    H = cuda_fft.hartley_cols_plain(G, n1)
    w = n1 // (2 * p)
    seen = np.zeros(n1, int)
    for r in range(p):
        P = cuda_fft.hartley_cols_range(G, w, r * w)
        want = torch.cat([H[..., r * w : r * w + w], H[..., n1 - r * w - w : n1 - r * w]], -1)
        _close(P.numpy(), want.numpy())
        seen[r * w : r * w + w] += 1
        seen[n1 - r * w - w : n1 - r * w] += 1
    assert (seen == 1).all()


def _virtual(stages, x, p, axis=0):
    """The stages of one transform composed over p virtual ranks: rank r's
    rows (of ``axis``), the two exchanges as transposes of the chunk lists."""
    rows, cols, place = stages
    b = x.shape[axis] // p
    sent = [rows(x.narrow(axis, r * b, b)) for r in range(p)]
    packed = [cols([sent[r][s] for r in range(p)], s) for s in range(p)]
    return torch.cat([place([packed[s][r] for s in range(p)], r) for r in range(p)], dim=axis)


def _jax_mesh():
    from jax.sharding import Mesh

    return Mesh(np.asarray(jax.devices()), ("fx",))


@pytest.mark.parametrize("shape", [(16, 16), (16, 24), (8, 16, 6), (16, 8, 2, 6)])
@pytest.mark.parametrize("p", [1, 2, 4, 8])
def test_pencil_stages_match_jax_sharded_hartley(shape, p):
    """The pencil Hartley's stages over p virtual ranks equal the JAX
    package's pencil transform on its 8-device mesh (float64)."""
    assert not (shape[0] % p or shape[1] % p)  # every case splits over every p
    x = np.random.default_rng(3).standard_normal(shape)
    if len(shape) == 2:
        want = np.asarray(jax_sharded_hartley2(jnp.asarray(x), _jax_mesh()))
    else:
        want = np.asarray(jax_hartley(jnp.asarray(x)))
    got = _virtual(pencil_stages(shape, p, torch.float64), torch.from_numpy(x)[None], p, axis=1)
    _close(got[0].numpy(), want)


@pytest.mark.parametrize("p", [1, 2, 4, 8])
def test_pencil_kernel_schedule_matches_jax(p):
    """A float32 grid in the kernels' domain takes K3 + K4r's schedule (the
    padded half spectrum, the halo column, the packed columns), here
    through their plain versions; against the JAX package in float64."""
    shape = (256, 512)
    assert uses_kernels(shape, p, torch.float32) and not uses_kernels(shape, p, torch.float64)
    x = np.random.default_rng(4).standard_normal(shape).astype(np.float32)
    want = np.asarray(jax_sharded_hartley2(jnp.asarray(x, jnp.float64), _jax_mesh()))
    got = _virtual(pencil_stages(shape, p, torch.float32), torch.from_numpy(x)[None], p, axis=1)
    _close(got[0].numpy(), want, atol=1e-6)


@pytest.mark.parametrize("p", [1, 2, 4])
def test_pencil_stages_odd_columns_match_jax_hartley(p):
    """An odd n1 (no Nyquist column: the last rank's last half-spectrum
    column is no column's mirror) against the JAX package's whole-field
    Hartley (float64)."""
    x = np.random.default_rng(6).standard_normal((16, 9))
    want = np.asarray(jax_hartley(jnp.asarray(x)))
    got = _virtual(pencil_stages(x.shape, p, torch.float64), torch.from_numpy(x)[None], p, axis=1)
    _close(got[0].numpy(), want)


BUFFER_CASES = {"f64": ((32, 64), torch.float64, 1), "f32_kernels": ((256, 512), torch.float32, 8)}


@pytest.mark.parametrize("case", sorted(BUFFER_CASES))
@pytest.mark.parametrize("p", [1, 2, 4, 8])
def test_pencil_buffers_compose_to_the_hartley(p, case):
    """The 2-D stages on the exchanges' packed buffers over p virtual ranks
    (the exchange a transpose of the ranks' buffers): stage 1 gives ``(p, B,
    rows, w + pad)`` (pad 8 for K3 + K4r's layout, 1 otherwise), stage 2
    takes that receive buffer and gives ``(p, B, rows, 2w)``, and stage 3
    places it; composed, ``hartley_cols_plain`` of the rows' ``rfft`` (f64)."""
    shape, dt, pad = BUFFER_CASES[case]
    x = torch.from_numpy(np.random.default_rng(7).standard_normal((2,) + shape)).to(dt)
    rows, cols, place = pencil_stages(shape, p, dt)
    b, w = shape[0] // p, shape[1] // (2 * p)
    sent = [rows(x[:, r * b:(r + 1) * b]) for r in range(p)]
    assert all(torch.is_tensor(t) and t.shape == (p, 2, b, w + pad) for t in sent)
    recv = [torch.stack([sent[r][s] for r in range(p)]) for s in range(p)]
    packed = [cols(recv[s], s) for s in range(p)]
    assert all(t.shape == (p, 2, b, 2 * w) and t.is_contiguous() for t in packed)
    back = [torch.stack([packed[s][r] for s in range(p)]) for r in range(p)]
    got = torch.cat([place(back[r], r) for r in range(p)], dim=1).double()
    want = cuda_fft.hartley_cols_plain(torch.fft.rfft(x.double(), dim=-1), shape[1])
    tol = TOL if dt == torch.float64 else 1e-5
    assert float((got - want).abs().max()) <= tol * float(want.abs().max())


@pytest.mark.parametrize("full, rows", [((16, 12), (0, 4)), ((16, 12), (8, 8)), ((16, 12), (6, 5)),
                                        ((9, 8, 6), (3, 3)), ((9, 8, 6), (6, 3))])
def test_mirror_unfold_rows_is_a_slice(full, rows):
    """``mirror_unfold(rows=)`` (the rank's core rows, then the trailing
    axes) equals the rows of the whole unfold; a core of ``n0`` rows (the
    leading axis not mirrored) too."""
    rng = np.random.default_rng(len(full) + rows[0])
    lo, n = rows
    for c0 in (full[0] // 2 + 1, full[0]):
        core = torch.from_numpy(rng.standard_normal((c0,) + tuple(k // 2 + 1 for k in full[1:]) + (2,)))
        want = ce.mirror_unfold(core, full)[lo : lo + n]
        assert torch.equal(ce.mirror_unfold(core, full, rows), want)
    with pytest.raises(ValueError, match="does not fit"):
        ce.mirror_unfold(core[:2], full, rows)


@pytest.mark.parametrize("p", [1, 2, 4, 8])
def test_fft_stages_match_jax_sharded_fft2(p):
    x = np.random.default_rng(5).standard_normal((16, 8))
    want = np.asarray(jax_sharded_fft2(jnp.asarray(x), _jax_mesh()))
    _close(_virtual(fft_stages(x.shape, p), torch.from_numpy(x).to(torch.complex128), p).numpy(), want)


# --- (c) the refusals and the helpers --------------------------------------------------


def test_host_local_slice():
    assert [parallel.host_local_slice(10, count=3, index=i) for i in range(3)] == [(0, 4), (4, 7), (7, 10)]
    assert parallel.host_local_slice(5, count=1, index=0) == (0, 5)
    assert parallel.process_count() == 1 and parallel.process_index() == 0


class _Mesh:
    """A stand-in for a DeviceMesh with one axis of ``p`` ranks."""

    mesh_dim_names = ("fx",)
    device_type = "cpu"

    def __init__(self, p):
        self.p = p

    def get_group(self, name):
        return None

    def size(self, dim=0):
        return self.p

    def get_local_rank(self, name):
        return 0


def _maker(shape, harmonic_type="fourier"):
    cfm = nt.CorrelatedFieldMaker("cf")
    cfm.set_amplitude_total_offset(0.5, (1e-1, 3e-2))
    cfm.add_fluctuations(shape, 1.0 / 8, (1.0, 0.5), (-3.0, 0.2), harmonic_type=harmonic_type)
    return cfm


def test_field_mesh_refusals_match_the_reference():
    """As the JAX package's ``finalize(field_mesh=)``: one regular Cartesian
    subgrid of ndim >= 2 whose two leading axes the axis size divides; a
    HEALPix grid raises; ``position_sharding`` needs a field mesh."""
    fin = dict(device="cpu", dtype=torch.float64)
    with pytest.raises(ValueError, match="divisible"):
        _maker((12, 10)).finalize(field_mesh=_Mesh(4), **fin)
    with pytest.raises(ValueError, match="regular-Cartesian"):
        _maker(4, "spherical").finalize(field_mesh=_Mesh(2), **fin)
    with pytest.raises(ValueError, match="ndim >= 2"):
        _maker((16,)).finalize(field_mesh=_Mesh(2), **fin)
    cf = _maker((8, 8)).finalize(field_mesh=_Mesh(2), **fin)
    sh = cf.position_sharding()
    assert sh["cfxi"].spec == ("fx",) and sh["cfzeromode"].spec == ()
    assert cf.position_sharding(batch_ndim=1)["cfxi"].spec == (None, "fx")
    assert cf.rows == (0, 4)
    with pytest.raises(ValueError, match="without a field mesh"):
        _maker((8, 8)).finalize(**fin).position_sharding()


@pytest.mark.parametrize("full, p", [((1024, 1024), 128), ((256, 4096), 256), ((768, 768), 96),
                                     ((768, 4096), 256)])
def test_kernel_layout_refusals(full, p):
    """A float32 2-D grid that K3 + K4r take is refused over a ``p`` that
    breaks their layout (``n1 % 16 p``, an even row count a rank) rather
    than sent to ``torch.fft``: by the stages and by ``finalize``; in
    float64 the same grid takes the ``torch.fft`` stages."""
    assert cuda_fft.cuda_hartley_supported(full, torch.float32)
    with pytest.raises(ValueError, match="K3 \\+ K4r"):
        uses_kernels(full, p, torch.float32)
    with pytest.raises(ValueError, match="K3 \\+ K4r"):
        pencil_stages(full, p, torch.float32)
    with pytest.raises(ValueError, match="K3 \\+ K4r"):
        _maker(full).finalize(device="cpu", dtype=torch.float32, field_mesh=_Mesh(p))
    assert not uses_kernels(full, p, torch.float64)
    assert uses_kernels(full, 2, torch.float32)


def _lh():
    return nt.Gaussian(torch.zeros(8, 8, dtype=torch.float64)).amend(_maker((8, 8)).finalize(
        device="cpu", dtype=torch.float64))


def test_devices_with_position_sharding_raises():
    """As the JAX package's ``OptimizeVI``: one mesh with both axes instead."""
    with pytest.raises(NotImplementedError, match="single mesh"):
        nt.OptimizeVI(_lh(), 1, devices=[0], position_sharding={"cfxi": None})


class _GroupMesh(_Mesh):
    """A stand-in whose field axis has a group (never used: the refusal
    comes first)."""

    def get_group(self, name):
        return object()


def test_position_sharding_refuses_data_not_rows():
    """``position_sharding=`` needs data that are the field's rows: a
    likelihood on the whole field's rows (or on a sum of the field) is
    refused at the first position, before any collective; one on the
    rank's rows passes."""
    fin = dict(device="cpu", dtype=torch.float64)
    cf = _maker((8, 8)).finalize(field_mesh=_GroupMesh(2), **fin)
    pos = {k: torch.zeros(s.shape, dtype=torch.float64) for k, s in cf.domain.items()}
    pos["cfxi"] = pos["cfxi"][:4]  # rank 0's rows
    for data in (torch.zeros(8, 8), torch.zeros(3)):
        opt = nt.OptimizeVI(nt.Gaussian(data.double()).amend(cf), 1,
                            position_sharding=cf.position_sharding())
        with pytest.raises(NotImplementedError, match="field's rows"):
            opt.draw_linear_samples(pos, [1])
        with pytest.raises(NotImplementedError, match="field's rows"):
            opt.kl_value_and_grad(pos, primals_samples=nt.Samples(pos=pos))
    opt = nt.OptimizeVI(nt.Gaussian(torch.zeros(4, 8, dtype=torch.float64)).amend(cf), 1,
                        position_sharding=cf.position_sharding())
    opt._check_rows(nt.Samples(pos=pos))
    assert opt._rows_checked


def test_named_sharding_placements():
    from torch.distributed.tensor import Replicate, Shard

    class _M2(_Mesh):
        mesh_dim_names = ("samples", "fx")

    assert parallel.NamedSharding(_M2(2), (None, "fx")).placements == (Replicate(), Shard(1))
    assert parallel.replicated_sharding(_M2(2)).placements == (Replicate(), Replicate())
    assert parallel.sample_sharding(_M2(2)).placements == (Shard(0), Replicate())


def test_initialize_picks_the_store():
    from nifty_tpu_torch.parallel.multihost import _init_method

    assert _init_method(None) == "env://"
    assert _init_method("/tmp/store") == "file:///tmp/store"
    assert _init_method("localhost:1234") == "tcp://localhost:1234"
    assert _init_method("file:///x") == "file:///x"


# --- (b) the ranks: 2 and 4 gloo processes -----------------------------------------------

WORKER = r'''
import json, os, sys
rank, nproc, store, d, root = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4], sys.argv[5]
sys.path.insert(0, root)
import numpy as np
import torch
torch.set_num_threads(1)
import nifty_tpu_torch as nt
from nifty_tpu_torch import parallel
from nifty_tpu_torch.parallel.mesh import NamedSharding
from nifty_tpu_torch.evi import seeds

parallel.initialize(store, nproc, rank, device="cpu")
assert parallel.process_count() == nproc and parallel.process_index() == rank
inp = dict(np.load(os.path.join(d, "inputs.npz")))
cfg = json.load(open(os.path.join(d, "config.json")))
f64 = torch.float64
out = {}
mesh = parallel.global_mesh(("fx",))
fx = NamedSharding(mesh, ("fx",))
T = lambda a: torch.from_numpy(np.asarray(a))

x = fx.shard(T(inp["x"]))
out["fft2"] = parallel.sharded_fft2(x, mesh).numpy()
for name in cfg["buffers"]:  # the packed exchanges' layout, K3 + K4r's plain versions for f32
    out["buffers_" + name] = parallel.sharded_hartley2(fx.shard(T(inp["xb_" + name])), mesh).numpy()
from nifty_tpu_torch.parallel import collectives
fxg = mesh.get_group("fx")
chunks = torch.arange(nproc * 12, dtype=f64).reshape(nproc, 3, 4) + 1000 * rank
out["exchange"] = collectives.exchange(chunks, fxg).numpy()
out["exchange_ref"] = torch.stack(collectives.all_to_all(list(chunks), [(3, 4)] * nproc, fxg)).numpy()
out["exchange_complex"] = collectives.exchange(torch.complex(chunks, -chunks), fxg).numpy()
sizes = [s + 1 for s in range(nproc)]  # rank s sends s + 1 entries to each; receives r + 1 from each
flat = torch.cat([torch.full((rank + 1,), 100.0 * rank + s, dtype=f64) for s in range(nproc)])
out["exchange_splits"] = collectives.exchange(flat, fxg, [rank + 1] * nproc, sizes).numpy()
h = parallel.sharded_hartley2(x, mesh)
out["hartley2"] = h.numpy()
out["hartley_twice"] = parallel.sharded_hartley2(h, mesh).numpy()


def tree(prefix):
    return {k[len(prefix):]: inp[k] for k in inp if k.startswith(prefix)}


def maker(shape, K=None):
    cfm = nt.CorrelatedFieldMaker("cf")
    cfm.set_amplitude_total_offset(0.5, (1e-1, 3e-2))
    cfm.add_fluctuations(shape, 1.0 / shape[0], (1.0, 0.5), (-3.0, 0.2), (1.0, 0.2), n_mode_knots=K)
    return cfm


def build(shape, fm, K=None):
    return maker(shape, K).finalize(device="cpu", dtype=f64, field_mesh=fm)


for name, shape, K in cfg["fields"]:
    cf = build(tuple(shape), mesh, K)
    sh = cf.position_sharding()
    with torch.no_grad():
        out["cf_" + name] = cf(nt.position_from_numpy(cf, tree(f"pos_{name}/"), sharding=sh)).numpy()

# the Poisson metric on the exact field
cf = build(tuple(cfg["shape"]), mesh)
sh = cf.position_sharding()
lh = nt.Poissonian(fx.shard(T(inp["counts"])), device="cpu").amend(nt.ChainModel(torch.exp, cf))
m = lh.metric(*(nt.position_from_numpy(cf, tree(f"{w}/"), sharding=sh) for w in ("mpos", "mtan")))
for k, v in m.items():
    out["metric/" + k] = v.detach().numpy()


def vi(mesh2, position_sharding=None, devices=None, n_samples=2, hook=False, cg=None, kl=None):
    """One MGVI iteration of the Gaussian model of the field."""
    cf = build(tuple(cfg["shape"]), None if position_sharding is None else mesh2)
    shd = cf.position_sharding() if position_sharding else None
    fld = shd["cfxi"] if shd else None
    data = T(inp["data"]) if fld is None else fld.shard(T(inp["data"]))
    lh = nt.Gaussian(data, noise_std_inv=lambda x: 5.0 * x, device="cpu").amend(cf)
    order = seeds(torch.Generator().manual_seed(42), n_samples)
    f_rank, f_size = (0, 1) if fld is None else (mesh2.get_local_rank("fx"), mesh2.size(mesh2.mesh_dim_names.index("fx")))

    def linear(lh_, pos, seed, **kw):  # the JAX package's draws, this rank's rows
        i = order.index(seed)
        rows = lambda a: torch.from_numpy(np.ascontiguousarray(  # noqa: E731
            np.split(a, f_size)[f_rank]))
        data = rows(inp[f"white{i}/data"])
        prior = {k[len(f"white{i}/prior/"):]: inp[k] for k in inp if k.startswith(f"white{i}/prior/")}
        prior = {k: rows(v) if k == "cfxi" else torch.from_numpy(v) for k, v in sorted(prior.items())}
        return nt.draw_linear_residual(lh_, pos, white=nt.WhiteNoise(data, prior), **kw)

    opt = nt.OptimizeVI(lh, 1, devices=devices, position_sharding=shd,
                        _draw_linear_residual=linear if hook else None)
    pos0 = nt.position_from_numpy(cf, tree("start/"), sharding=shd)
    s, _ = nt.optimize_kl(lh, pos0, key=torch.Generator().manual_seed(42), n_total_iterations=1,
                          n_samples=n_samples, draw_linear_kwargs=dict(cg_kwargs=cg or cfg["cg"]),
                          kl_kwargs=dict(minimize_kwargs=kl or cfg["kl"]),
                          sample_mode="linear_resample", _optimize_vi=opt)
    return s, opt


s, opt = vi(mesh, position_sharding=True, hook=True)
for k, v in s.pos.items():
    out["vi_field/" + k] = v.numpy()
whole = opt.gather(s)
for k, v in whole.pos.items():
    out["vi_field_gathered/" + k] = v.numpy()
s, _ = vi(None, devices=parallel.sample_mesh(), n_samples=cfg["devices_samples"],
          cg=cfg["short_cg"], kl=cfg["short_kl"])
for k, v in s.pos.items():
    out["vi_devices/" + k] = v.numpy()
for k, v in s._samples.items():
    out["vi_devices_samples/" + k] = v.numpy()
if nproc == 4:
    mesh2 = parallel.global_mesh(("samples", "fx"), (2, 2))
    s, opt = vi(mesh2, position_sharding=True, hook=True)
    whole = opt.gather(s)
    for k, v in whole.pos.items():
        out["vi_2d/" + k] = v.numpy()
    out["vi_2d_samples"] = np.asarray(len(whole))
out["pmap"] = nt.get_map("pmap")(lambda a, b: a * b.sum(), in_axes=(0, None))(
    torch.arange(10.0, dtype=f64).reshape(5, 2), torch.ones(3, dtype=f64)).numpy()
np.savez(os.path.join(d, f"out{rank}.npz"), **out)
print("done", rank, flush=True)
'''


def _jax_field(shape, K=None):
    cfm = nj.CorrelatedFieldMaker("cf")
    cfm.set_amplitude_total_offset(0.5, (1e-1, 3e-2))
    cfm.add_fluctuations(shape, 1.0 / shape[0], (1.0, 0.5), (-3.0, 0.2), (1.0, 0.2), n_mode_knots=K)
    return cfm.finalize()


FIELDS = [("exact2d", SHAPE, None), ("knot2d", SHAPE, 8), ("exact3d", SHAPE_3D, None),
          ("knot3d", SHAPE_3D, 8)]


def _draw(domain, rng, scale=1.0):
    return {k: scale * rng.standard_normal(v.shape) for k, v in sorted(domain.items())}


def _inputs():
    """The inputs of the ranks (numpy), and the JAX objects that
    :func:`_wants` reads: the reference's field and its likelihood."""
    rng = np.random.default_rng(11)
    inp = {"x": rng.standard_normal(SHAPE)}
    for name, shape, K in FIELDS:
        pos = _draw(_jax_field(shape, K).domain, rng)
        inp.update({f"pos_{name}/{k}": v for k, v in pos.items()})
    cf = _jax_field(SHAPE)
    inp["counts"] = rng.poisson(1.0, SHAPE).astype(np.int64)
    mpos, mtan = _draw(cf.domain, rng, 0.3), _draw(cf.domain, rng)
    inp.update({f"mpos/{k}": v for k, v in mpos.items()})
    inp.update({f"mtan/{k}": v for k, v in mtan.items()})
    # one MGVI iteration of the reference's test (tests/test_parallel.py)
    truth = np.asarray(cf(cf.init(random.PRNGKey(10))))
    inp["data"] = truth + 0.2 * rng.standard_normal(SHAPE)
    start = _draw(cf.domain, rng, 0.1)
    inp.update({f"start/{k}": v for k, v in start.items()})
    rb = np.random.default_rng(12)
    for name, (shape, dt, _) in sorted(BUFFER_CASES.items()):
        inp["xb_" + name] = rb.standard_normal(shape).astype(np.float32 if dt == torch.float32 else np.float64)
    lhj = nj.Gaussian(jnp.asarray(inp["data"]), noise_std_inv=lambda x: 5.0 * x).amend(cf)
    _, sk = random.split(random.PRNGKey(42), 2)
    for i, k in enumerate(random.split(sk, 2)):  # the keys of the iteration's draws
        k_nll, k_prr = random.split(k, 2)
        inp[f"white{i}/data"] = np.array(jax_random_like(k_nll, lhj.left_sqrt_metric_tangents_shape))
        prior = jax_random_like(k_prr, start)
        for name, v in zip(sorted(start), jax.tree_util.tree_leaves(prior)):
            inp[f"white{i}/prior/{name}"] = np.array(v)
    return inp, cf, lhj, start


def _wants(inp, cf, lhj, start):
    """The JAX package's results on the inputs."""
    tree = lambda prefix: {k[len(prefix):]: jnp.asarray(v) for k, v in inp.items()  # noqa: E731
                           if k.startswith(prefix)}
    x = inp["x"]
    want = {"fft2": np.fft.fft2(x), "hartley2": np.asarray(jax_hartley(jnp.asarray(x))),
            "hartley_twice": x * x.size}
    for name in BUFFER_CASES:
        xb = jnp.asarray(inp["xb_" + name], jnp.float64)
        want["buffers_" + name] = np.asarray(jax_sharded_hartley2(xb, _jax_mesh()))
    for name, shape, K in FIELDS:
        want["cf_" + name] = np.asarray(_jax_field(shape, K)(tree(f"pos_{name}/")))
    lh = nj.Poissonian(jnp.asarray(inp["counts"])).amend(nj.ChainModel(jnp.exp, cf))
    m = lh.metric(tree("mpos/"), tree("mtan/"))
    want.update({"metric/" + k: np.asarray(v) for k, v in dict(m).items()})
    pj = nj.Vector({k: jnp.asarray(v) for k, v in start.items()})
    sj, _ = nj.optimize_kl(lhj, pj, n_total_iterations=1, n_samples=2, key=random.PRNGKey(42),
                           draw_linear_kwargs=dict(cg_kwargs=CG),
                           kl_kwargs=dict(minimize_kwargs=KL), sample_mode="linear_resample",
                           odir=None)
    want["vi"] = {k: np.asarray(v) for k, v in dict(sj.pos.tree).items()}
    return want


def _port_devices_run(data, start, n_samples):
    """The port's one-process run that ``devices=`` must reproduce."""
    cfm = nt.CorrelatedFieldMaker("cf")
    cfm.set_amplitude_total_offset(0.5, (1e-1, 3e-2))
    cfm.add_fluctuations(SHAPE, 1.0 / SHAPE[0], (1.0, 0.5), (-3.0, 0.2), (1.0, 0.2))
    cf = cfm.finalize(device="cpu", dtype=torch.float64)
    lh = nt.Gaussian(torch.from_numpy(data), noise_std_inv=lambda x: 5.0 * x).amend(cf)
    s, _ = nt.optimize_kl(lh, nt.position_from_numpy(cf, start),
                          key=torch.Generator().manual_seed(42), n_total_iterations=1,
                          n_samples=n_samples, draw_linear_kwargs=dict(cg_kwargs=SHORT_CG),
                          kl_kwargs=dict(minimize_kwargs=SHORT_KL), sample_mode="linear_resample")
    return s


def _start(d, nproc, inp):
    """Write the inputs and start ``nproc`` worker processes in ``d``."""
    d = str(d)
    np.savez(os.path.join(d, "inputs.npz"), **inp)
    cfg = dict(fields=[[n, list(s), K] for n, s, K in FIELDS], shape=list(SHAPE), cg=CG, kl=KL,
               buffers=sorted(BUFFER_CASES),
               short_cg=SHORT_CG, short_kl=SHORT_KL, devices_samples=nproc)
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump(cfg, f)
    script = os.path.join(d, "worker.py")
    with open(script, "w") as f:
        f.write(WORKER)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    store = os.path.join(d, "store")
    return d, [subprocess.Popen([sys.executable, script, str(r), str(nproc), store, d, ROOT],
                                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                                env=env) for r in range(nproc)]


def _finish(d, procs):
    """Wait for the workers; their shards, a dict a rank."""
    logs = []
    try:
        for pr in procs:
            logs.append(pr.communicate(timeout=240)[0])
    finally:
        for pr in procs:
            if pr.poll() is None:
                pr.kill()
    for pr, log in zip(procs, logs):
        assert pr.returncode == 0, log[-4000:]
    return [dict(np.load(os.path.join(d, f"out{r}.npz"))) for r in range(len(procs))]


@pytest.fixture(scope="module")
def launches(tmp_path_factory):
    """One launch of 2 ranks and one of 4, side by side, and the port's
    one-process runs that their ``devices=`` runs must reproduce; the JAX
    package's results are computed while the ranks run."""
    inp, cf, lhj, start = _inputs()
    started = {n: _start(tmp_path_factory.mktemp(f"ranks{n}"), n, inp) for n in (2, 4)}
    want = _wants(inp, cf, lhj, start)
    one = {n: _port_devices_run(inp["data"], start, n) for n in (2, 4)}
    return {n: (_finish(*started[n]), one[n]) for n in (2, 4)}, want


RANKS = pytest.mark.parametrize("nproc", [2, 4])


@RANKS
@pytest.mark.parametrize("check", ["fft2", "hartley2", "hartley_twice"])
def test_sharded_transforms_match_local(launches, nproc, check):
    """tests/test_parallel.py's transforms: each rank's rows of the FFT, the
    Hartley and the Hartley applied twice (N x)."""
    (outs, _), want = launches[0][nproc], launches[1]
    for r, out in enumerate(outs):
        _close(out[check], _rows(want[check], r, nproc))


@RANKS
@pytest.mark.parametrize("name", sorted(BUFFER_CASES))
def test_sharded_hartley_buffers_match_jax(launches, nproc, name):
    """``sharded_hartley2`` through the packed exchanges (stage 2 reading
    the receive buffer in place and writing the send buffer) on 2 and 4
    gloo ranks: each rank's rows of the JAX package's sharded Hartley on its
    8-device mesh (float64; a float32 field in K3 + K4r's domain, their
    plain versions, within 1e-5 of the maximum)."""
    (outs, _), want = launches[0][nproc], launches[1]
    tol = TOL if BUFFER_CASES[name][1] == torch.float64 else 1e-5
    scale = np.abs(want["buffers_" + name]).max()
    for r, out in enumerate(outs):
        _close(out["buffers_" + name] / scale, _rows(want["buffers_" + name], r, nproc) / scale, atol=tol)


@RANKS
def test_exchange_matches_all_to_all(launches, nproc):
    """``collectives.exchange`` of one packed buffer, chunk s for rank s:
    what ``all_to_all`` of the chunks gives, complex as real views, and
    with split sizes (rank s sends s + 1 entries to each rank)."""
    outs = launches[0][nproc][0]
    for r, out in enumerate(outs):
        np.testing.assert_array_equal(out["exchange"], out["exchange_ref"])
        want = np.stack([np.arange(nproc * 12.0).reshape(nproc, 3, 4)[r] + 1000 * s for s in range(nproc)])
        np.testing.assert_array_equal(out["exchange"], want)
        np.testing.assert_array_equal(out["exchange_complex"], want - 1j * want)
        np.testing.assert_array_equal(out["exchange_splits"],
                                      np.concatenate([np.full(s + 1, 100.0 * s + r) for s in range(nproc)]))


@RANKS
@pytest.mark.parametrize("name", [n for n, _, _ in FIELDS])
def test_field_sharded_forward_matches_jax(launches, nproc, name):
    """finalize(field_mesh=): each rank's rows of the JAX package's
    unsharded cf(pos), exact and 8 knots, 2-D and 3-D."""
    (outs, _), want = launches[0][nproc], launches[1]
    for r, out in enumerate(outs):
        _close(out["cf_" + name], _rows(want["cf_" + name], r, nproc))


@RANKS
def test_field_sharded_poisson_metric_matches_jax(launches, nproc):
    """The metric: ξ's rows on each rank, the replicated leaves whole (their
    cotangents summed over the ranks)."""
    (outs, _), want = launches[0][nproc], launches[1]
    for r, out in enumerate(outs):
        for k in [k for k in want if k.startswith("metric/")]:
            ref = _rows(want[k], r, nproc) if k.endswith("cfxi") else want[k]
            _close(out[k], ref)


@RANKS
def test_position_sharded_optimize_kl_matches_jax(launches, nproc):
    """One MGVI iteration with position_sharding= (the JAX package's draws)
    against the JAX package's one-device run: 1e-4, the reference's
    bound; gathered, the position is the whole one."""
    (outs, _), want = launches[0][nproc], launches[1]
    for r, out in enumerate(outs):
        for k, v in want["vi"].items():
            np.testing.assert_allclose(out["vi_field/" + k], _rows(v, r, nproc) if k == "cfxi" else v,
                                       atol=1e-4, rtol=0)
            np.testing.assert_array_equal(out["vi_field_gathered/" + k],
                                          np.concatenate([o["vi_field/" + k] for o in outs])
                                          if k == "cfxi" else out["vi_field/" + k])


@RANKS
def test_devices_optimize_kl_matches_one_process(launches, nproc):
    """``devices=``: each rank its share of the sample pairs, from the seeds
    of the one-process run; the position and each rank's samples within
    1e-8 of the port's one-process run."""
    outs, one = launches[0][nproc]
    for r, out in enumerate(outs):
        for k, v in one.pos.items():
            _close(out["vi_devices/" + k], v.numpy(), atol=1e-8)
        lo, hi = parallel.host_local_slice(nproc, count=nproc, index=r)
        for k, v in one._samples.items():
            _close(out["vi_devices_samples/" + k], v[2 * lo : 2 * hi].numpy(), atol=1e-8)


def test_samples_and_field_mesh_optimize_kl_matches_jax(launches):
    """4 ranks: the 2 x 2 ("samples", "fx") mesh of tests/test_parallel.py,
    samples over one axis and the field over the other, against the JAX
    package's one-device run (1e-4); gathered: 4 samples."""
    (outs, _), want = launches[0][4], launches[1]
    for out in outs:
        assert int(out["vi_2d_samples"]) == 4
        for k, v in want["vi"].items():
            np.testing.assert_allclose(out["vi_2d/" + k], v, atol=1e-4, rtol=0)


@RANKS
def test_pmap_maps_samples_over_the_ranks(launches, nproc):
    """``get_map("pmap")``: every rank gets every output, in order."""
    outs = launches[0][nproc][0]
    want = np.arange(10.0).reshape(5, 2) * 3.0
    for out in outs:
        np.testing.assert_array_equal(out["pmap"], want)
