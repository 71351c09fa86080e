"""Port parity: the HEALPix pixelisation, the Legendre contraction (K5/K6's
plain versions) and the spherical-harmonic synthesis and analysis.

Both packages get the same numpy inputs, float64 on the CPU.  Tolerances,
and why:

- ring geometry, the real-alm packing, the recurrence tables and every
  HEALPix index function: exact (the same integer and float64 formulas);
  the pixel angles to 2 ulp (the reference runs compiled, and XLA divides
  by a constant as a multiplication by its reciprocal);
- the plain Legendre contraction and its transpose against the JAX
  package's scan: relative 1e-12 (the same recurrence; the port runs it
  for all m at once and sums the hemispheres in another order), and the
  adjoint identity <S a, y> = <a, Sᵀ y> to 1e-12;
- the syntheses, their adjoints and the analyses: 1e-10 of the largest
  value (FFTs and the factored cap DFT round differently from the JAX
  package's chunked one);
- the Gauss-Legendre grid at odd lmax (an even ring count, which the JAX
  package's fold does not take): against a dense transform from scipy's
  spherical harmonics, 1e-10;
- the kernels' schedule and their column staging (models of
  ``csrc/legendre.cu``'s index arithmetic, which the CPU cannot run):
  exact; the λ-table products that ``chip_smoke.py`` times as K5/K6's
  library yardstick: 1e-6 of the largest value (the table is float32).
"""

import copy

import jax
import numpy as np
import pytest
import torch
from functools import partial

from jax import numpy as jnp
from scipy.special import sph_harm_y

import nifty_tpu.ops.jhealpix as jj
import nifty_tpu.ops.sht as js
from nifty_tpu_torch.ops import cuda_legendre as cl
from nifty_tpu_torch.ops import jhealpix as tj
from nifty_tpu_torch.ops import sht as ts

torch.set_num_threads(1)


def _close(got, want, rtol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * max(np.abs(want).max(), 1e-300))


def _jit(f, *args, **static):
    """The JAX reference, compiled once (its eager op-by-op dispatch is slow)."""
    return jax.jit(partial(f, *args, **static))


def _alm(lmax, mmax, seed, batch=()):
    return np.random.default_rng(seed).standard_normal(batch + (cl.alm_size(lmax, mmax),))


# --- HEALPix indices ------------------------------------------------------------


@pytest.mark.parametrize("nside", [1, 2, 4, 8])
def test_jhealpix_matches_jax(nside):
    pix = np.arange(12 * nside * nside)
    z, phi = (np.asarray(v) for v in _jit(jj.pix2ang_ring, nside)(pix))
    zt, phit = tj.pix2ang_ring(nside, pix)
    # float64 angles to 2 ulp: the compiled reference divides by a
    # constant as a multiplication by its reciprocal
    np.testing.assert_array_max_ulp(zt.numpy(), z, maxulp=2)
    np.testing.assert_array_max_ulp(phit.numpy(), phi, maxulp=2)
    np.testing.assert_array_equal(tj.ang2pix_ring(nside, z, phi).numpy(),
                                  np.asarray(_jit(jj.ang2pix_ring, nside)(z, phi)))
    for name in ("ring2hpd", "nest2hpd"):
        for a, b in zip(getattr(tj, name)(nside, pix), _jit(getattr(jj, name), nside)(pix)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    x, y, f = (np.asarray(v) for v in _jit(jj.nest2hpd, nside)(pix))
    np.testing.assert_array_equal(tj.hpd2ring(nside, x, y, f).numpy(),
                                  np.asarray(_jit(jj.hpd2ring, nside)(x, y, f)))
    np.testing.assert_array_equal(tj.hpd2nest(nside, x, y, f).numpy(), pix)
    for name in ("nest2ring", "ring2nest"):
        np.testing.assert_array_equal(getattr(tj, name)(nside, pix).numpy(),
                                      np.asarray(_jit(getattr(jj, name), nside)(pix)))
    for nest in (False, True):
        got = tj.neighbors(nside, pix, nest=nest)
        assert got.dtype == torch.int64
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(_jit(jj.neighbors, nside, nest=nest)(pix)))


def test_jhealpix_int64_beyond_int32():
    """NEST <-> RING at nside 2^14 (npix 3.2e9 > 2^31), where int32 wraps."""
    nside = 2**14
    pix = torch.tensor([0, 12 * nside * nside - 1, 5 * nside * nside + 12345, 2**31 + 7])
    ring = tj.nest2ring(nside, pix)
    assert ring.dtype == torch.int64 and bool((ring < 12 * nside * nside).all())
    np.testing.assert_array_equal(tj.ring2nest(nside, ring).numpy(), pix.numpy())
    with pytest.raises(ValueError, match="power-of-two"):
        tj.nest2ring(3, pix)


# --- geometry, packing, tables ----------------------------------------------------


@pytest.mark.parametrize("nside", [1, 2, 4, 8])
def test_ring_geometry_and_packing_match_jax(nside):
    for a, b in zip(ts.healpix_ring_geometry(nside), js.healpix_ring_geometry(nside)):
        np.testing.assert_array_equal(a, b)
    lmax, mmax = 2 * nside, max(nside, 1)
    for a, b in zip(cl.real_alm_index_maps(lmax, mmax), js._real_alm_index_maps(lmax, mmax)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(cl.recurrence_tables(lmax, mmax), js._recurrence_tables(lmax, mmax)):
        np.testing.assert_array_equal(a, b)
    x = _alm(lmax, mmax, 0)
    for a, b in zip(ts.unpack_real_alm(torch.from_numpy(x), lmax, mmax),
                    js.unpack_real_alm(jnp.asarray(x), lmax, mmax)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


# --- the Legendre contraction (the plain versions of K5 and K6) ----------------------


def _grid(kind):
    if kind == "healpix":
        z = js.healpix_ring_geometry(4)[0]
        return z, 8, 6
    z = js.gauss_legendre_grid(10)[0]  # 11 rings: the equator is one
    return z, 10, 10


@pytest.mark.parametrize("kind", ["healpix", "gauss_legendre"])
def test_legendre_contract_plain_matches_jax(kind):
    z, lmax, mmax = _grid(kind)
    plan = cl.LegendrePlan(z, lmax, mmax)
    alm = _alm(lmax, mmax, 1, (2,))
    got = cl.legendre_contract_plain(torch.from_numpy(alm), plan).numpy()
    c_re, c_im = js.unpack_real_alm(jnp.asarray(alm), lmax, mmax)
    ct, st = jnp.asarray(z), jnp.asarray(np.sqrt(1.0 - z**2))
    f_c, f_s = _jit(js._legendre_contract_impl, lmax=lmax, mmax=mmax, fold=True)(c_re, c_im, ct, st)
    _close(got[..., 0], f_c, 1e-12)
    _close(got[..., 1], f_s, 1e-12)

    cot = np.random.default_rng(2).standard_normal((2, z.size, mmax + 1, 2))
    gt = cl.legendre_contract_t_plain(torch.from_numpy(cot), plan)
    g_re, g_im = _jit(js._legendre_contract_transpose, lmax=lmax, mmax=mmax, fold=True)(
        jnp.asarray(cot[..., 0]), jnp.asarray(cot[..., 1]), ct, st)
    re_t, im_t = ts.unpack_real_alm(gt, lmax, mmax)
    _, msk_re, _, msk_im = cl.real_alm_index_maps(lmax, mmax)
    _close(re_t.numpy(), np.asarray(g_re) * msk_re, 1e-12)
    _close(im_t.numpy(), np.asarray(g_im) * msk_im, 1e-12)

    lhs = float((got * cot).sum())
    rhs = float((alm * gt.numpy()).sum())
    assert abs(lhs - rhs) <= 1e-12 * abs(lhs)


def test_legendre_functions_batch_jvp_and_adjoint():
    """The autograd pair: under vmap one call per batch (the mapped axis in
    the kernels' batch) equal to a loop, jvp the map itself, the backward
    K6; on ``meta`` only shapes."""
    z, lmax, mmax = _grid("healpix")
    plan = cl.LegendrePlan(z, lmax, mmax)
    x = torch.from_numpy(_alm(lmax, mmax, 3, (3, 2)))
    calls = []
    orig = cl.legendre_contract

    def counting(alm, plan_):
        calls.append(tuple(alm.shape))
        return orig(alm, plan_)

    cl.legendre_contract = counting
    try:
        out = torch.func.vmap(lambda a: ts.LegendreContract.apply(a, plan))(x)
    finally:
        cl.legendre_contract = orig
    assert calls == [(6, plan.size)]
    loop = torch.stack([ts.LegendreContract.apply(a, plan) for a in x])
    assert torch.equal(out, loop)
    _, tan = torch.func.jvp(lambda a: ts.LegendreContract.apply(a, plan), (x[0],), (x[1],))
    assert torch.equal(tan, ts.LegendreContract.apply(x[1], plan))
    cot = torch.randn(out.shape[1:], dtype=torch.float64, generator=torch.Generator().manual_seed(0))
    pulled = torch.func.vjp(lambda a: ts.LegendreContract.apply(a, plan), x[0])[1](cot)[0]
    assert torch.equal(pulled, ts.LegendreContractT.apply(cot, plan))
    meta = ts.LegendreContract.apply(torch.empty((2, plan.size), device="meta"),
                                     copy.deepcopy(plan).to("meta"))
    assert meta.shape == (2, plan.n_rings, mmax + 1, 2) and meta.is_meta


# --- the kernels' schedule and staging (models of csrc/legendre.cu) -----------------


def _schedule_plan(kind):
    if kind == "even_mmax":  # a self-paired middle column
        return cl.LegendrePlan(js.healpix_ring_geometry(4)[0], 8, 8)
    if kind == "odd_mmax_below_lmax":
        return cl.LegendrePlan(js.healpix_ring_geometry(4)[0], 9, 5)
    if kind == "even_mmax_below_lmax":
        return cl.LegendrePlan(js.healpix_ring_geometry(8)[0], 12, 6)
    if kind == "even_ring_count":  # odd lmax: no equator ring
        return cl.LegendrePlan(js.gauss_legendre_grid(11)[0], 11, 11)
    if kind == "rings_512":  # one CUDA-core K6 block, 4 tensor-core chunks
        return cl.LegendrePlan(js.healpix_ring_geometry(256)[0], 4, 3)
    return cl.LegendrePlan(js.healpix_ring_geometry(1024)[0], 3, 3)  # 2,048 rings: K6 chunks


@pytest.mark.parametrize("kind", ["even_mmax", "odd_mmax_below_lmax", "even_mmax_below_lmax",
                                  "even_ring_count", "rings_512", "rings_2048"])
@pytest.mark.parametrize("B", [1, 2, 5, 8, 19])
def test_kernel_schedule_covers_each_column_ring_and_sample_once(kind, B):
    """Every block of K5 and K6 as ``launch_config`` launches it (grid x: ring
    chunk, y: column group, z: sample group): each (sample, m, northern
    ring) exactly once.  A block walks the pair ``plan.pairs[y]`` with
    thread ``tid`` of chunk x taking rings (x K + k) threads + tid, or (the
    tensor-core K5) ``columns`` consecutive columns, a warp each, over rings
    32 x + lane; a pair walks 2 lmax - mmax + 2 values of l (the
    self-paired middle column half as many)."""
    plan = _schedule_plan(kind)
    pairs = plan.pairs.numpy()
    np.testing.assert_array_equal(pairs, cl.column_pairs(plan.mmax))
    for row in pairs:
        steps = sum(plan.lmax - m + 1 for m in row if m >= 0)
        assert steps == (plan.lmax - plan.mmax // 2 + 1 if row[1] < 0 else 2 * plan.lmax - plan.mmax + 2)
    for transpose in (False, True):
        cfg = cl.launch_config(plan, B, transpose)
        assert cfg.mma == (B >= cl.MMA_MIN_BATCH)
        hits = np.zeros((B, plan.mmax + 1, plan.n_half), dtype=np.int64)
        if cfg.columns:
            assert cfg.columns == cfg.threads // 32
            groups = [list(range(y * cfg.columns, min((y + 1) * cfg.columns, plan.mmax + 1)))
                      for y in range(-(-(plan.mmax + 1) // cfg.columns))]
        else:
            groups = [[m for m in row if m >= 0] for row in pairs]
        for cols in groups:
            for c in range(cfg.n_chunks):
                if cfg.columns:
                    rings = 32 * c + np.arange(32)
                else:
                    rings = ((c * cfg.rings_per_thread + np.arange(cfg.rings_per_thread))[:, None]
                             * cfg.threads + np.arange(cfg.threads)[None, :]).ravel()
                rings = rings[rings < plan.n_half]
                for z in range(-(-B // cfg.samples)):
                    samples = np.arange(z * cfg.samples, min((z + 1) * cfg.samples, B))
                    for m in cols:
                        hits[np.ix_(samples, [m], rings)] += 1
        assert (hits == 1).all()
        if transpose:  # one launch unless the rings outgrow a block
            assert (cfg.n_chunks == 1) == (plan.n_half <= (512 if cfg.mma else 1024))


def _slot_words(n):
    return (n + 6) & ~3  # csrc/legendre.cu slot_words


@pytest.mark.parametrize("lmax,mmax", [(8, 8), (9, 5), (12, 12)])
@pytest.mark.parametrize("base", [0, 1, 2, 3])
def test_column_staging_model_unpacks_to_the_jax_packing(lmax, mmax, base):
    """K5's staging of a sample's alm column (``csrc/legendre.cu`` stage /
    alm_span) for an input ``base`` floats past a 16-byte boundary: the bulk
    copy's source, destination and size are multiples of 16 bytes, the <= 3
    words before and after it go by plain loads, the slot holds them, and
    the staged column read at the kernel's offsets (2 (l - m) + part, or l
    at m = 0) gives the JAX package's unpacked coefficients."""
    B = 3
    alm = _alm(lmax, mmax, base, (B,))
    re, im = (np.asarray(v) for v in js.unpack_real_alm(jnp.asarray(alm), lmax, mmax))
    col_off = cl.LegendrePlan(js.healpix_ring_geometry(2)[0], lmax, mmax).col_offset.numpy()
    flat = np.concatenate([np.full(base, np.nan), alm.ravel()])  # word 0: 16-byte aligned
    for b in range(B):
        for m in range(mmax + 1):
            n = lmax + 1 if m == 0 else 2 * (lmax - m + 1)
            src = base + b * alm.shape[1] + int(col_off[m])  # in words from the aligned base
            lead = src & 3
            head = min(n, (4 - lead) & 3)
            body = ((n - head) >> 2) << 2
            assert head <= 3 and n - head - body <= 3 and lead + n <= _slot_words(n)
            slot = np.full(_slot_words(n), np.nan)  # a 16-byte-aligned slot
            if body:
                assert (src + head) % 4 == 0 and (lead + head) % 4 == 0 and body % 4 == 0
                slot[lead + head:lead + head + body] = flat[src + head:src + head + body]
            for w in list(range(head)) + list(range(head + body, n)):
                slot[lead + w] = flat[src + w]
            col = slot[lead:lead + n]
            ls = np.arange(m, lmax + 1)
            if m == 0:
                np.testing.assert_array_equal(col, re[b, :, 0])
            else:
                np.testing.assert_array_equal(col[0::2], re[b, ls, m])
                np.testing.assert_array_equal(col[1::2], im[b, ls, m])


@pytest.mark.parametrize("kind", ["healpix", "gauss_legendre"])
def test_lambda_table_products_match_plain(kind):
    """``bench.workload.legendre_table``'s float32 λ table: one ``torch.bmm``
    gives K5, one with its transpose K6 (chip_smoke.py's library yardstick)."""
    from nifty_tpu_torch.bench.workload import legendre_bmm_operands, legendre_table

    z, lmax, mmax = _grid(kind)
    plan = cl.LegendrePlan(z, lmax, mmax)
    alm = torch.from_numpy(_alm(lmax, mmax, 4, (3,)))
    cot = torch.from_numpy(np.random.default_rng(5).standard_normal((3, z.size, mmax + 1, 2)))
    table = legendre_table(plan)
    assert table.dtype == torch.float32 and table.shape == (mmax + 1, 2 * plan.n_half, lmax + 1)
    c, G, ring_side, packed = legendre_bmm_operands(plan, alm, cot)
    _close(ring_side(torch.bmm(table.double(), c)), cl.legendre_contract_plain(alm, plan), 1e-6)
    _close(packed(torch.bmm(table.double().transpose(1, 2), G)),
           cl.legendre_contract_t_plain(cot, plan), 1e-6)


def test_plan_keeps_float64_tables():
    z, lmax, mmax = _grid("healpix")
    plan = cl.LegendrePlan(z, lmax, mmax).to(dtype=torch.float32)
    assert plan.seed.dtype == plan.ab.dtype == plan.cos_half.dtype == torch.float64
    with pytest.raises(ValueError, match="symmetric"):
        cl.LegendrePlan(z[:-1], lmax, mmax)


# --- synthesis and analysis ---------------------------------------------------------


@pytest.mark.parametrize("nside,lmax,mmax", [(2, 4, 4), (4, 8, 8), (4, 8, 5), (8, 16, 16)])
def test_healpix_synthesis_matches_jax(nside, lmax, mmax):
    x = _alm(lmax, mmax, nside + mmax)
    got = ts.healpix_synthesis(torch.from_numpy(x), nside, lmax, mmax)
    synth_j = _jit(js.healpix_synthesis, nside=nside, lmax=lmax, mmax=mmax)
    _close(got.numpy(), synth_j(jnp.asarray(x)), 1e-10)
    y = np.random.default_rng(5).standard_normal(12 * nside * nside)
    synth = ts.HealpixSynthesis(nside, lmax, mmax)
    pulled = torch.func.vjp(synth, torch.zeros(x.size, dtype=torch.float64))[1](torch.from_numpy(y))[0]
    want = jax.jit(jax.linear_transpose(synth_j, jnp.asarray(x)))(jnp.asarray(y))[0]
    _close(pulled.numpy(), want, 1e-10)


def test_get_healpix_synthesis_over_an_axis_matches_jax():
    """An axis in the middle, every other axis a batch: one K5 launch."""
    nside, lmax, mmax = 2, 4, 4
    x = _alm(lmax, mmax, 7, (2, 3))
    x = np.moveaxis(x, -1, 1)  # (2, size, 3)
    f = ts.get_healpix_synthesis(nside, 1, lmax, mmax, device="cpu", dtype=torch.float64)
    calls = []
    orig = cl.legendre_contract
    cl.legendre_contract = lambda a, p: calls.append(a.shape) or orig(a, p)
    try:
        got = f(torch.from_numpy(x))
    finally:
        cl.legendre_contract = orig
    assert calls == [(6, x.shape[1])]
    want = jax.jit(js.get_healpix_synthesis(nside, 1, lmax, mmax))(jnp.asarray(x))
    _close(got.numpy(), want, 1e-10)


def test_healpix_analysis_matches_jax():
    nside, lmax = 4, 6
    x = _alm(lmax, lmax, 9)
    m = np.asarray(_jit(js.healpix_synthesis, nside=nside, lmax=lmax, mmax=lmax)(jnp.asarray(x)))
    got = ts.healpix_analysis(torch.from_numpy(m), nside, lmax)
    _close(got.numpy(), _jit(js.healpix_analysis, nside=nside, lmax=lmax)(jnp.asarray(m)), 1e-10)
    _close(got.numpy(), x, 1e-6)  # a band-limited map comes back


def test_gauss_legendre_even_lmax_matches_jax():
    lmax = 8
    x = _alm(lmax, lmax, 11)
    f = ts.gauss_legendre_synthesis(torch.from_numpy(x), lmax)
    want = _jit(js.gauss_legendre_synthesis, lmax=lmax)(jnp.asarray(x))
    _close(f.numpy(), want, 1e-10)
    _close(ts.gauss_legendre_analysis(f, lmax).numpy(),
           _jit(js.gauss_legendre_analysis, lmax=lmax)(jnp.asarray(want)), 1e-10)


def _dense_gauss_legendre(x, lmax, mmax):
    """Synthesis on the Gauss-Legendre grid from scipy's Y_lm."""
    z, _, n_phi = js.gauss_legendre_grid(lmax)
    theta = np.arccos(z)[:, None]
    phi = 2.0 * np.pi * np.arange(n_phi)[None, :] / n_phi
    c_re, c_im = (np.asarray(v) for v in js.unpack_real_alm(jnp.asarray(x), lmax, mmax))
    out = np.zeros((z.size, n_phi))
    for l in range(lmax + 1):
        for m in range(min(l, mmax) + 1):
            lam = sph_harm_y(l, m, theta, 0.0).real
            if m == 0:
                out += c_re[l, 0] * lam
            else:
                out += np.sqrt(2.0) * lam * (c_re[l, m] * np.cos(m * phi) - c_im[l, m] * np.sin(m * phi))
    return np.sqrt(4.0 * np.pi) * out


@pytest.mark.parametrize("lmax,mmax", [(7, 7), (9, 5)])
def test_gauss_legendre_odd_lmax_matches_dense(lmax, mmax):
    """An odd lmax: lmax + 1 (even) rings, no equator ring."""
    x = _alm(lmax, mmax, lmax)
    f = ts.gauss_legendre_synthesis(torch.from_numpy(x), lmax, mmax)
    _close(f.numpy(), _dense_gauss_legendre(x, lmax, mmax), 1e-10)
    _close(ts.gauss_legendre_analysis(f, lmax, mmax).numpy(), x, 1e-10)


def test_synthesis_refusals():
    with pytest.raises(ValueError, match="aliases"):
        ts.HealpixSynthesis(2, 8, 8)
    with pytest.raises(ValueError, match="n_phi"):
        ts.gauss_legendre_synthesis(torch.zeros(cl.alm_size(4, 4), dtype=torch.float64), 4, n_phi=4)
