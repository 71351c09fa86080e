"""Port parity: the Hartley transform and the mode-table expansion.

The same numpy inputs go through ``nifty_tpu`` and ``nifty_tpu_torch``.
On CPU tensors the port's kernel wrappers run their plain versions, which
are what the CUDA kernels are held against on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).  The Pallas kernels run
in interpret mode, as their own tests run them.

Tolerances: float64 paths agree to rtol 1e-10 (both sides are exact
algorithms in double precision); float32 Hartleys to 1e-5 of max|ref|
(f32 FFT rounding); gathers exactly (a gather computes nothing).
"""

import os
import re
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from jax import numpy as jnp

from nifty_tpu.models.correlated_field import make_grid as jax_make_grid
from nifty_tpu.ops import mode_expand as jme
from nifty_tpu.ops.fft import hartley as jax_hartley
from nifty_tpu_torch.ops import cuda_expand, cuda_fft
from nifty_tpu_torch.ops import mode_expand as tme
from nifty_tpu_torch.ops.fft import hartley, hartley_plain

torch.set_num_threads(1)


def _close(a, b, rtol):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    np.testing.assert_allclose(a, b, rtol=rtol, atol=rtol * np.abs(b).max())


# --- Hartley -----------------------------------------------------------------


@pytest.mark.parametrize(
    "shape,axes",
    [
        ((17,), None),
        ((64,), None),
        ((12, 9), None),
        ((15, 16), None),
        ((7, 10, 6), None),
        ((5, 8, 9), (1, 2)),
        ((6, 11), (0,)),
    ],
)
def test_hartley_plain_matches_jax_f64(shape, axes):
    x = np.random.default_rng(0).standard_normal(shape)
    want = jax_hartley(jnp.asarray(x), axes=axes)
    _close(hartley(torch.from_numpy(x), axes=axes).numpy(), want, 1e-10)


def test_hartley_complex_input_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((6, 10)) + 1j * rng.standard_normal((6, 10))
    _close(hartley(torch.from_numpy(x)).numpy(), jax_hartley(jnp.asarray(x)), 1e-10)


@pytest.mark.parametrize("shape", [(256, 256), (256, 512)])
def test_hartley2d_matches_pallas_interpret(shape):
    from nifty_tpu.ops.pallas_fft import hartley2d_pallas

    x = np.random.default_rng(2).standard_normal(shape).astype(np.float32)
    want = np.asarray(hartley2d_pallas(jnp.asarray(x)))
    xt = torch.from_numpy(x)
    got = cuda_fft.Hartley2d.apply(xt)
    assert got.dtype == torch.float32
    assert np.abs(got.numpy() - want).max() / np.abs(want).max() < 1e-5


@pytest.mark.parametrize("shape", [(256, 256), (512, 768), (256, 1280)])
def test_hartley_rows_cols_plain_compose_to_hartley(shape):
    x = np.random.default_rng(3).standard_normal(shape)
    G = cuda_fft.hartley_rows(torch.from_numpy(x))
    assert G.shape == (shape[0], shape[1] // 2 + 1)
    H = cuda_fft.hartley_cols(G, shape[1])
    _close(H.numpy(), hartley_plain(torch.from_numpy(x)).numpy(), 1e-10)


def test_hartley_dispatch_is_by_shape_and_dtype():
    assert cuda_fft.cuda_hartley_supported((256, 256), torch.float32)
    assert cuda_fft.cuda_hartley_supported((1280, 10240), torch.float32)
    assert cuda_fft.cuda_hartley_supported((512, 768), torch.float32)
    assert not cuda_fft.cuda_hartley_supported((256, 256), torch.float64)
    assert not cuda_fft.cuda_hartley_supported((255, 256), torch.float32)
    assert not cuda_fft.cuda_hartley_supported((128, 256), torch.float32)
    assert not cuda_fft.cuda_hartley_supported((256,), torch.float32)
    assert not cuda_fft.cuda_hartley_supported((256, 256, 256), torch.float32)
    assert not cuda_fft.cuda_hartley_supported((256 * 11, 256), torch.float32)
    assert not cuda_fft.cuda_hartley_supported((256, 2 * cuda_fft.MAX_AXIS), torch.float32)


def test_hartley2d_function_is_linear_and_self_adjoint():
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((256, 256)).astype(np.float32))
    t = torch.from_numpy(rng.standard_normal((256, 256)).astype(np.float32))
    f = cuda_fft.Hartley2d.apply
    _, jt = torch.func.jvp(f, (x,), (t,))
    torch.testing.assert_close(jt, f(t), rtol=0, atol=0)
    _, vjp_fn = torch.func.vjp(f, x)
    torch.testing.assert_close(vjp_fn(t)[0], f(t), rtol=0, atol=0)
    y = f(f(x)) / x.numel()
    assert (y - x).abs().max() < 1e-4


def _register_dft(a, R):
    """Numpy model of the kernel's register DFT along axis 0: radix 16 and
    8 as 4-point DFTs over r1 (r = R2 r1 + r2), the twiddle w_R^{r2 q1},
    then R2-point DFTs over r2 (q = q1 + 4 q2); other radices direct."""
    if R in (8, 16):
        R2 = R // 4
        t = np.stack([_register_dft(a[[r2 + r1 * R2 for r1 in range(4)]], 4) for r2 in range(R2)])
        w = np.exp(-2j * np.pi * np.outer(np.arange(R2), np.arange(4)) / R)
        t = t * w.reshape(w.shape + (1,) * (a.ndim - 1))
        out = np.empty_like(a)
        for q1 in range(4):
            u = _register_dft(t[:, q1], R2)
            for q2 in range(R2):
                out[q1 + 4 * q2] = u[q2]
        return out
    W = np.exp(-2j * np.pi * np.outer(np.arange(R), np.arange(R)) / R)
    return np.tensordot(W, a, axes=(1, 0))


def _kernel_fft_model(x, table_len=0):
    """Numpy model of one sequence through the passes of ``fft_plan``, with
    the index arithmetic of ``csrc/hartley.cu``: padded shared-memory
    positions, j / m by the magic multiplier, in-place butterflies over
    g L + k + r m, twiddles w^{q k tw_stride} from the two tables (of length
    ``table_len``, default n), and the output read through
    ``output_order``.  Checks each pass's invariants."""
    n = x.size
    table_len = table_len or n
    lo, hi = cuda_fft.twiddle_tables(table_len)
    pos = cuda_fft.smem_pos
    buf = np.full(cuda_fft.buffer_len(n), np.nan + 0j)
    buf[pos(np.arange(n))] = x
    L = n
    for R, m, magic, tws in cuda_fft.fft_plan(n, table_len):
        assert m * R == L and tws * L == table_len
        j = np.arange(n // R, dtype=np.uint64)
        g = j if m == 1 else (j * np.uint64(magic)) >> np.uint64(32)  # __umulhi
        g, j = g.astype(np.int64), j.astype(np.int64)
        np.testing.assert_array_equal(g, j // m)
        k = j - g * m
        at = pos(g * L + k + np.arange(R)[:, None] * m)  # read and written in place
        assert np.unique(at).size == n and at.max() < cuda_fft.buffer_len(n)
        e = np.arange(R)[:, None] * k[None] * tws
        assert 0 <= e.min() and e.max() < table_len  # the index stays inside the tables
        tw = lambda e: hi[e >> 7] * lo[e & (cuda_fft.TW_LO - 1)]
        if R in (8, 16):  # w^q = w^(q mod 4) w^(4 (q div 4)), as the kernel forms it
            q = np.arange(R)[:, None]
            w = tw((q % 4) * k[None] * tws) * tw(4 * (q // 4) * k[None] * tws)
        else:
            w = tw(e)
        buf[at] = _register_dft(buf[at], R) * w
        L = m
    assert L == 1
    return buf[pos(cuda_fft.output_order(n).astype(np.int64))]


@pytest.mark.parametrize("n", [256, 768, 1280, 1792, 4096, 10240, 24576])
def test_pass_schedule_composes_to_the_dft(n):
    """The kernels' pass schedule, in-place exchange, twiddle indices,
    output order and padded positions, modelled in numpy, reproduce
    ``np.fft.fft``; 768, 1280, 1792 and 10240 take radices 3, 5, 7 and 8,
    24576 radix 2."""
    rads = cuda_fft.radix_plan(n)
    assert rads[-1] == 16 and int(np.prod(rads)) == n
    order = cuda_fft.output_order(n)
    assert np.array_equal(np.sort(order), np.arange(n))  # a permutation
    rng = np.random.default_rng(n)
    x = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    _close(_kernel_fft_model(x), np.fft.fft(x), 1e-10)


@pytest.mark.parametrize("n,C", [(256, 2), (1280, 2), (4096, 2), (1280, 4), (4096, 4), (10240, 4)])
def test_cluster_cross_pass_and_part_transforms_give_the_dft(n, C):
    """K4's clusters of C blocks: the radix-C pass across the parts of a
    column (the register DFT of x[k], x[k + n/C], ..., output q times
    w_n^{q k}), then in each part the passes of the length n/C plan with
    the length-n tables; frequency C f + r is in part r at
    ``output_order(n // C)[f]``."""
    rng = np.random.default_rng(n + C)
    x = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    lo, hi = cuda_fft.twiddle_tables(n)
    part = n // C
    k = np.arange(part)
    y = _register_dft(x.reshape(C, part), C)
    e = np.arange(C)[:, None] * k[None]
    y = y * hi[e >> 7] * lo[e & (cuda_fft.TW_LO - 1)]
    out = np.empty(n, complex)
    for r in range(C):
        out[r::C] = _kernel_fft_model(y[r], table_len=n)
    _close(out, np.fft.fft(x), 1e-10)


@pytest.mark.parametrize("R", [2, 3, 4, 5, 7, 8, 16])
def test_register_dft_is_the_dft(R):
    a = np.random.default_rng(R).standard_normal((R, 3)) + 0j
    W = np.exp(-2j * np.pi * np.outer(np.arange(R), np.arange(R)) / R)
    _close(_register_dft(a, R), W @ a, 1e-12)


@pytest.mark.parametrize("n", [256, 768, 1280, 1792, 4096, 10240, 12288, cuda_fft.MAX_AXIS])
def test_launch_shapes_fit_the_card(n):
    """Every launch shape respects the kernels' thread bounds and a block's
    227 KB of shared memory, and K4's last tile stays inside the padded
    row pitch."""
    T = cuda_fft.row_launch(n)
    assert 1 <= T <= min(n // 16, cuda_fft.MAX_THREADS) and cuda_fft.MAX_THREADS == 640
    assert cuda_fft.row_smem_bytes(n) <= cuda_fft.SMEM_LIMIT == 227 * 1024
    T, tc, parts = cuda_fft.col_launch(n)
    assert (tc, parts) in ((1, 0), (2, 0), (8, 2), (8, 4))
    assert 1 <= T <= n // 16 and (tc + (parts > 0)) * T <= cuda_fft.MAX_THREADS
    assert cuda_fft.col_smem_bytes(n, tc, parts) <= cuda_fft.SMEM_LIMIT
    assert not parts or (n // parts) % parts == 0  # the cross pass splits evenly
    # the last tile (and the extra column, which only tiles short of n1/2 read) stays
    # inside the padded pitch
    assert (-(-(n // 2 + 1) // tc)) * tc <= cuda_fft.half_spectrum_pitch(n)
    if n <= 10240:  # clusters: 32-byte runs of 8 columns, the mirror aligned
        assert parts and tc == 8
    else:  # one block a tile: 2 columns at 12288, 1 at 24576 (both in test_torch_cuda.py)
        assert not parts and tc == {12288: 2, cuda_fft.MAX_AXIS: 1}[n]


def test_half_spectrum_pitch_and_padded_copy():
    for n1 in (256, 1280, 4096, 10240):
        pitch = cuda_fft.half_spectrum_pitch(n1)
        assert pitch % 8 == 0 and pitch >= n1 // 2 + 8
    rng = np.random.default_rng(12)
    G = torch.from_numpy(rng.standard_normal((256, 129)) + 1j * rng.standard_normal((256, 129)))
    Gp = cuda_fft.padded_half_spectrum(G)
    assert Gp.shape == G.shape and Gp.stride() == (cuda_fft.half_spectrum_pitch(256), 1)
    assert torch.equal(Gp, G)
    full = Gp.as_strided((256, Gp.stride(0)), Gp.stride())
    assert not full[:, 129:].abs().any()
    _close(cuda_fft.hartley_cols(Gp, 256).numpy(), cuda_fft.hartley_cols_plain(G, 256).numpy(), 0)
    assert cuda_fft.fft_plan(256 * 11) is None and cuda_fft.radix_plan(256 * 13) is None


# --- mode expansion ----------------------------------------------------------


def _layout(shape):
    g = jax_make_grid(shape, 1.0 / shape[0], "fourier")
    pd = np.asarray(g.harmonic_grid.power_distributor, dtype=np.int32)
    core = pd[tuple(slice(0, n // 2 + 1) for n in pd.shape)]
    return core, int(g.harmonic_grid.mode_lengths.size)


@pytest.mark.parametrize("shape,kind", [((48, 48), "rfp2"), ((48, 64), "flat"), ((33, 33), "rfp2")])
def test_build_expand_layout_matches_jax(shape, kind):
    core, U = _layout(shape)
    packed_j, layout_j = jme.build_expand_layout(core, U)
    packed_t, layout_t = tme.build_expand_layout(core, U)
    assert layout_t.kind == kind == layout_j.kind
    assert tuple(layout_t) == tuple(layout_j)
    np.testing.assert_array_equal(packed_t, np.asarray(packed_j))


def test_expand_index_csr_is_a_stable_sort():
    core, U = _layout((48, 48))
    packed, layout = tme.build_expand_layout(core, U)
    index = tme.ExpandIndex(packed, layout)
    idx = packed.ravel()
    perm = index.perm.numpy()
    off = index.offsets.numpy()
    np.testing.assert_array_equal(perm, np.argsort(idx, kind="stable"))
    np.testing.assert_array_equal(np.diff(off), np.bincount(idx, minlength=U))
    np.testing.assert_array_equal(idx[perm], np.repeat(np.arange(U), np.diff(off)))
    large = np.flatnonzero(np.diff(off) > cuda_expand.LARGE_BIN)
    np.testing.assert_array_equal(index.large_bins.numpy(), large)


def test_expand_index_rejects_out_of_range():
    core, U = _layout((16, 16))
    packed, layout = tme.build_expand_layout(core, U)
    with pytest.raises(ValueError):
        tme.ExpandIndex(packed + U, layout)


def _tables(U, B, seed):
    rng = np.random.default_rng(seed)
    shape = (U,) if B is None else (U, B)
    return rng.standard_normal(shape), rng.standard_normal(shape)


@pytest.mark.parametrize("shape", [(48, 48), (48, 64)])
@pytest.mark.parametrize("B", [None, 3])
def test_mode_expand_matches_jax(shape, B):
    core, U = _layout(shape)
    packed, layout = jme.build_expand_layout(core, U)
    index = tme.ExpandIndex(*tme.build_expand_layout(core, U))
    tab, tan = _tables(U, B, 5)
    fj = lambda t: jme.mode_expand(t, packed, layout)
    ft = lambda t: tme.mode_expand(t, index)
    want = np.asarray(fj(jnp.asarray(tab)))
    got = ft(torch.from_numpy(tab)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, tab[core] if B is None else tab[core, :])
    # jvp
    _, jt_j = jax.jvp(fj, (jnp.asarray(tab),), (jnp.asarray(tan),))
    _, jt_t = torch.func.jvp(ft, (torch.from_numpy(tab),), (torch.from_numpy(tan),))
    np.testing.assert_array_equal(jt_t.numpy(), np.asarray(jt_j))
    # vjp
    cot = np.random.default_rng(6).standard_normal(want.shape)
    _, vj = jax.vjp(fj, jnp.asarray(tab))
    _, vt = torch.func.vjp(ft, torch.from_numpy(tab))
    _close(vt(torch.from_numpy(cot))[0].numpy(), np.asarray(vj(jnp.asarray(cot))[0]), 1e-10)


@pytest.mark.parametrize("shape", [(48, 48), (48, 64)])
@pytest.mark.parametrize("B", [None, 2])
def test_mode_expand_collapse_adjoint(shape, B):
    core, U = _layout(shape)
    index = tme.ExpandIndex(*tme.build_expand_layout(core, U))
    tab, _ = _tables(U, B, 7)
    out_shape = core.shape + (() if B is None else (B,))
    c = np.random.default_rng(8).standard_normal(out_shape)
    lhs = float((tme.mode_expand(torch.from_numpy(tab), index) * torch.from_numpy(c)).sum())
    rhs = float((torch.from_numpy(tab) * tme.mode_collapse(torch.from_numpy(c), index)).sum())
    assert abs(lhs - rhs) <= 1e-12 * max(abs(lhs), 1.0)
    # collapse is the segment sum over the core's bins
    ref = np.zeros((U,) + (() if B is None else (B,)))
    np.add.at(ref, core.ravel(), c.reshape((-1,) + ref.shape[1:]))
    _close(tme.mode_collapse(torch.from_numpy(c), index).numpy(), ref, 1e-10)


def test_mode_collapse_backward_is_expand():
    core, U = _layout((48, 48))
    index = tme.ExpandIndex(*tme.build_expand_layout(core, U))
    c = torch.from_numpy(np.random.default_rng(9).standard_normal(core.shape))
    g = torch.from_numpy(np.random.default_rng(10).standard_normal(U))
    _, vjp_fn = torch.func.vjp(lambda x: tme.mode_collapse(x, index), c)
    np.testing.assert_array_equal(vjp_fn(g)[0].numpy(), tme.mode_expand(g, index).numpy())
    _, jt = torch.func.jvp(lambda x: tme.mode_collapse(x, index), (c,), (c,))
    np.testing.assert_array_equal(jt.numpy(), tme.mode_collapse(c, index).numpy())


def test_expand_plain_matches_pallas_interpret_48():
    """The plain K1/K2 against the Pallas kernels (interpret mode) on the
    48² exact layout, followed by the JAX package's rfp2 unpack and mirror
    unfold (K1) and preceded by their adjoints (K2)."""
    from nifty_tpu.models.correlated_field import _mirror_unfold as jax_mirror_unfold
    from nifty_tpu.ops import pallas_expand as pe
    from nifty_tpu.ops.route import build_expand_plan

    full = (48, 48)
    core, U = _layout(full)
    packed, layout = jme.build_expand_layout(core, U)
    plan = build_expand_plan(np.asarray(packed).ravel(), U)
    index = tme.ExpandIndex(*tme.build_expand_layout(core, U))
    assert index.layout.kind == "rfp2"
    unpack = lambda G: jax_mirror_unfold(
        jme._unpack_rfp2(G.reshape(layout.packed_shape), layout, batched=False), full
    )
    rng = np.random.default_rng(11)
    tab = rng.standard_normal(U).astype(np.float32)
    G = pe.expand_forward(plan, jnp.asarray(tab), interpret=True)
    want = np.asarray(unpack(G))
    got = cuda_expand.expand_to_grid(torch.from_numpy(tab), index, full).numpy()
    np.testing.assert_array_equal(got, want)
    cot = rng.standard_normal(full).astype(np.float32)
    _, fold = jax.vjp(unpack, G)
    want = np.asarray(pe.expand_transpose(plan, fold(jnp.asarray(cot))[0], interpret=True))
    got = cuda_expand.collapse_from_grid(torch.from_numpy(cot), index, full).numpy()
    assert np.abs(got - want).max() / np.abs(want).max() < 1e-6


def test_wrappers_refuse_other_devices():
    core, U = _layout((16, 16))
    index = tme.ExpandIndex(*tme.build_expand_layout(core, U))
    with pytest.raises(ValueError):
        cuda_expand.expand_to_grid(torch.zeros(U, device="meta"), index, (16, 16))
    with pytest.raises(ValueError):
        cuda_expand.collapse_from_grid(torch.zeros((16, 16), device="meta"), index, (16, 16))
    with pytest.raises(ValueError):
        cuda_fft.hartley_rows(torch.zeros((256, 256), device="meta"))


# --- K1 / K2 on the full grid --------------------------------------------------


def _full_layout(full):
    core, U = _layout(full)
    packed, layout = tme.build_expand_layout(core, U)
    return core, U, packed, layout


def _images(x, c, n):
    """The full-grid images of core point x on an axis, in the kernels'
    order: x, then n - x on a mirrored axis' upper half."""
    return [x, n - x] if 1 <= x <= n - c else [x]


def _packed_images(geom):
    """Numpy model of the kernels' addressing: for each packed position,
    the full-grid points it covers, in the order K2 sums them.  rfp2: core
    point (a, b), a <= b, at R[a, b] if a <= m else R[b-m, a-m-1], then its
    transpose; flat: the core point at its row-major position.  On each
    core point the mirror images, slabs, rows, then columns."""
    n0, n1, n2, c0, c1, c2, m = geom
    out = {}
    if m < 0:
        for x0, x1, x2 in np.ndindex(c0, c1, c2):
            out[(x0 * c1 + x1) * c2 + x2] = [
                (s, r, c) for s in _images(x0, c0, n0) for r in _images(x1, c1, n1)
                for c in _images(x2, c2, n2)
            ]
        return out
    H = c2
    for a, b in np.ndindex(H, H):
        if a <= b:
            p = (b - m) * H + (a - m - 1) if a > m else a * H + b
            out[p] = [
                (0, r, c) for x1, x2 in (((a, b), (b, a)) if a < b else ((a, b),))
                for r in _images(x1, c1, n1) for c in _images(x2, c2, n2)
            ]
    return out


@pytest.mark.parametrize(
    "full,kind",
    [((8, 8), "rfp2"), ((9, 9), "rfp2"), ((64, 64), "rfp2"), ((10, 10), "flat"),
     ((66, 66), "flat"), ((12, 20), "flat"), ((17,), "flat"), ((6, 8, 10), "flat")],
)
def test_kernel_addressing_model(full, kind):
    """The kernels' packed point -> core point(s) -> full-grid images map
    (``csrc/expand.cu``) covers the grid once and reproduces the packed
    index after ``_rfp_index_table`` and the mirror unfold (K1); summed in
    its order it gives the plain mirror fold + rfp2 fold (K2).  8² and 64²
    are n = 0 mod 4 (H odd, rfp2), 10² and 66² n = 2 mod 4 (H even, flat),
    9² an odd n."""
    core, U, packed, layout = _full_layout(full)
    assert layout.kind == kind
    if kind == "rfp2":
        np.testing.assert_array_equal(tme._rfp_index_table(core), packed)
    geom = cuda_expand.grid_geometry(layout, full)
    cover = _packed_images(geom)
    assert sorted(cover) == list(range(packed.size))  # every packed point, once
    # K1: each packed point's index written to its images gives the core
    # index after the mirror unfold, every grid point written once
    grid = np.full(geom[:3], -1)
    for p, pts in cover.items():
        for pt in pts:
            assert grid[pt] == -1
            grid[pt] = packed.ravel()[p]
    want = cuda_expand.mirror_unfold(torch.from_numpy(core), full).numpy()
    np.testing.assert_array_equal(grid.reshape(full), want)
    # K2: the images summed in order give the plain mirror fold + rfp2 fold
    cot = np.random.default_rng(sum(full)).standard_normal(full)
    c3 = cot.reshape(geom[:3])
    folded = np.array([sum(c3[pt] for pt in cover[p]) for p in range(packed.size)])
    plain = cuda_expand.mirror_fold(torch.from_numpy(cot), layout.core_shape)
    if kind == "rfp2":
        plain = cuda_expand._fold_rfp2(plain, layout)
    _close(folded, plain.numpy().ravel(), 1e-12)
    # launch 2 sums each bin's members in CSR order
    index = tme.ExpandIndex(packed, layout)
    perm, off = index.perm.numpy(), index.offsets.numpy()
    seg = np.array([folded[perm[off[u] : off[u + 1]]].sum() for u in range(U)])
    _close(cuda_expand.collapse_from_grid(torch.from_numpy(cot), index, full).numpy(), seg, 1e-12)


def _expand_rfp2_runs(geom, V):
    """Numpy model of K1's rfp2 stores (``csrc/expand.cu:expand_row``): for
    each tile pair (I, J), I <= J, thread row r, run q and the transpose
    flag, the points written, as (I, J, shared cell, grid point, the run's
    first column, whether the run is whole)."""
    _, n1, n2, _, c1, c2, _ = geom
    T = -(-c2 // 32)
    for I, J, r, q in np.ndindex(T, T, 32, 32 // V):
        for tr in (False, True) if I < J else ((False,) if I == J else ()):
            a, cb = (32 * J + r, 32 * I) if tr else (32 * I + r, 32 * J)
            if a >= c1:
                continue
            c0 = V * q
            hi = min(V, c2 - cb - c0)  # direct columns cb + c0 + k, k < hi
            lo = max(0, cb + 32 - c0 - (n2 - c2))  # mirror images of cb + 32 - c0 - k, k >= lo
            runs = [(cb + c0, [(k, c0 + k) for k in range(max(hi, 0))], hi == V),
                    (n2 - cb - 32 + c0, [(k, 32 - c0 - k) for k in range(lo, V)], lo == 0)]
            for j0, points, whole in runs:
                for k, col in points:
                    for i in _images(a, c1, n1):
                        yield I, J, ((col, r) if tr else (r, col)), (i, j0 + k), j0, whole


@pytest.mark.parametrize(
    "n,full,V",
    [(8, (8, 8), 4), (40, (40, 40), 4), (68, (68, 68), 4), (96, (96, 96), 4),
     (64, (64, 64), 1), (9, (9, 9), 1), (65, (65, 65), 1), (64, (33, 33), 4), (64, (64, 33), 1)],
)
def test_expand_rfp2_store_runs(n, full, V):
    """K1's rfp2 write schedule on the core of an n² grid: the direct run
    of columns cb .. cb+31 and the mirror run of cb+1 .. cb+32 cover the
    grid once with the mirror unfold of the core, read only the 33 x 33
    shared tile, and a whole run starts on a multiple of V wherever the
    row pitch is one (16-byte stores).  68² has n/2 = 2 mod 4 (runs cut at
    the centre), 9² and 65² odd n, 33² no mirror, 64×33 a mirror on rows
    only."""
    core, U = _layout((n, n))
    packed, layout = tme.build_expand_layout(core, U)
    assert layout.kind == "rfp2"
    H = layout.core_shape[0]
    geom = cuda_expand.grid_geometry(layout, full)
    grid = np.full(full, -1)
    for I, J, (r, c), (i, j), j0, whole in _expand_rfp2_runs(geom, V):
        x, y = 32 * I + r, 32 * J + c
        assert r <= 32 and c <= 32 and x < H and y < H  # a cell the block loaded
        assert grid[i, j] == -1
        grid[i, j] = core[x, y]
        if whole and full[1] % V == 0:
            assert j0 % V == 0
    np.testing.assert_array_equal(grid, cuda_expand.mirror_unfold(torch.from_numpy(core), full).numpy())


def test_grid_geometry_pads_to_three_axes_and_checks_shapes():
    _, _, _, layout = _full_layout((64, 64))
    assert cuda_expand.grid_geometry(layout, (64, 64)) == (1, 64, 64, 1, 33, 33, 33 // 2)
    assert cuda_expand.grid_geometry(layout, (33, 33)) == (1, 33, 33, 1, 33, 33, 16)
    assert cuda_expand.grid_geometry(layout, (65, 65))[:3] == (1, 65, 65)
    _, _, _, flat = _full_layout((6, 8, 10))
    assert cuda_expand.grid_geometry(flat, (6, 8, 10)) == (6, 8, 10, 4, 5, 6, -1)
    for bad in ((64, 66), (64,), (68, 68), (64, 64, 1)):
        with pytest.raises(ValueError):
            cuda_expand.grid_geometry(layout, bad)


@pytest.mark.parametrize("full", [(48, 48), (50, 50), (48, 64), (40,), (6, 8, 10)])
@pytest.mark.parametrize("B", [None, 3])
def test_expand_to_grid_matches_jax(full, B):
    """K1 (plain) against the JAX ``mode_expand`` + ``_mirror_unfold`` in
    f64: exactly; K2 against the JAX composite's vjp to 1e-10."""
    from nifty_tpu.models.correlated_field import _mirror_unfold as jax_mirror_unfold

    core, U = _layout(full)
    packed, layout = jme.build_expand_layout(core, U)
    index = tme.ExpandIndex(*tme.build_expand_layout(core, U))
    tab, _ = _tables(U, B, 12)
    fj = lambda t: jax_mirror_unfold(jme.mode_expand(t, packed, layout), full)
    want = np.asarray(fj(jnp.asarray(tab)))
    got = cuda_expand.expand_to_grid(torch.from_numpy(tab), index, full).numpy()
    np.testing.assert_array_equal(got, want)
    cot = np.random.default_rng(13).standard_normal(want.shape)
    _, vj = jax.vjp(fj, jnp.asarray(tab))
    got = cuda_expand.collapse_from_grid(torch.from_numpy(cot), index, full).numpy()
    _close(got, np.asarray(vj(jnp.asarray(cot))[0]), 1e-10)


@pytest.mark.parametrize("full", [(48, 48), (48, 64)])
@pytest.mark.parametrize("B", [None, 3])
def test_mode_expand_grid_adjoint_and_transforms(full, B):
    """⟨K1 t, c⟩ = ⟨t, K2 c⟩; under ``torch.func`` the jvp of K1 is K1 and
    its vjp is K2 (and the other way round)."""
    core, U = _layout(full)
    index = tme.ExpandIndex(*tme.build_expand_layout(core, U))
    tab, tan = (torch.from_numpy(a) for a in _tables(U, B, 14))
    c = torch.from_numpy(np.random.default_rng(15).standard_normal(full + (() if B is None else (B,))))
    f = lambda t: tme.mode_expand_grid(t, index, full)
    g = lambda x: tme.ModeCollapseGrid.apply(x, index, full)
    lhs, rhs = float((f(tab) * c).sum()), float((tab * g(c)).sum())
    assert abs(lhs - rhs) <= 1e-12 * max(abs(lhs), 1.0)
    _, jt = torch.func.jvp(f, (tab,), (tan,))
    np.testing.assert_array_equal(jt.numpy(), f(tan).numpy())
    _, vjp_fn = torch.func.vjp(f, tab)
    np.testing.assert_array_equal(vjp_fn(c)[0].numpy(), g(c).numpy())
    _, jt = torch.func.jvp(g, (c,), (c,))
    np.testing.assert_array_equal(jt.numpy(), g(c).numpy())
    _, vjp_fn = torch.func.vjp(g, c)
    np.testing.assert_array_equal(vjp_fn(tab)[0].numpy(), f(tab).numpy())


def test_port_never_imports_jax():
    """Importing every module of the port (HMC, NUTS, the likelihoods,
    parametric VI, the tree linear algebra, the priors, the responses, the
    dynamics priors, the operators and the checks, the sphere, the
    multi-grid fields, the diagnostics and the output modules among them), and
    chip_smoke.py, loads no jax, no optax (the card's machine has none) and
    nothing of nifty_tpu; no import statement in chip_smoke.py names them
    either (its imports run inside main)."""
    import pkgutil

    import nifty_tpu_torch

    modules = sorted(
        m.name for m in pkgutil.walk_packages(nifty_tpu_torch.__path__, "nifty_tpu_torch.")
    )
    assert {"nifty_tpu_torch.evi", "nifty_tpu_torch.optimize_kl", "nifty_tpu_torch.ops.pwl",
            "nifty_tpu_torch.hmc", "nifty_tpu_torch.hmc_oo", "nifty_tpu_torch.mcmc",
            "nifty_tpu_torch.likelihood_impl", "nifty_tpu_torch.variational_models",
            "nifty_tpu_torch.utils.tree_linalg", "nifty_tpu_torch.models.prior",
            "nifty_tpu_torch.models.gauss_markov", "nifty_tpu_torch.num.stats_distributions",
            "nifty_tpu_torch.model", "nifty_tpu_torch.likelihood",
            "nifty_tpu_torch.optimize", "nifty_tpu_torch.los", "nifty_tpu_torch.ski",
            "nifty_tpu_torch.ops.nufft", "nifty_tpu_torch.models.dynamics",
            "nifty_tpu_torch.operators", "nifty_tpu_torch.extra", "nifty_tpu_torch.ops.ndimage",
            "nifty_tpu_torch.ops.gather_reduce", "nifty_tpu_torch.ops.jhealpix",
            "nifty_tpu_torch.ops.sht", "nifty_tpu_torch.ops.cuda_legendre",
            "nifty_tpu_torch.num.unique", "nifty_tpu_torch.multi_grid",
            "nifty_tpu_torch.multi_grid.grid", "nifty_tpu_torch.multi_grid.kernel",
            "nifty_tpu_torch.multi_grid.matern", "nifty_tpu_torch.multi_grid.correlated_field",
            "nifty_tpu_torch.multi_grid.healpix_grid",
            "nifty_tpu_torch.multi_grid.sphere_radius", "nifty_tpu_torch.adjust_variances",
            "nifty_tpu_torch.check_model", "nifty_tpu_torch.config_file",
            "nifty_tpu_torch.empirical_power_spectrum", "nifty_tpu_torch.io",
            "nifty_tpu_torch.operator_spectrum", "nifty_tpu_torch.plot",
            "nifty_tpu_torch.probing", "nifty_tpu_torch.profiling",
            "nifty_tpu_torch.utils.misc", "nifty_tpu_torch.utils.pytree_string"} <= set(modules)
    code = (
        f"import sys, importlib, chip_smoke; [importlib.import_module(m) for m in {modules!r}]; "
        "bad = [m for m in sys.modules if m in ('jax', 'optax', 'nifty_tpu')"
        " or m.startswith(('jax.', 'optax.', 'nifty_tpu.'))]; print(bad); sys.exit(1 if bad else 0)"
    )
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, timeout=120, cwd=root
    )
    assert res.returncode == 0, res.stdout + res.stderr
    with open(os.path.join(root, "chip_smoke.py")) as f:
        src = f.read()
    assert not re.search(r"^\s*(from|import)\s+(jax|optax|nifty_tpu)\b", src, re.M)
