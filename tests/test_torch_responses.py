"""The port's responses against nifty_tpu on the CPU, float64.

Line of sight (exact tables and values, the sampled integral in its three
broadcast forms), ``map_coordinates`` at the grid's edges, the
gather-reduce Function under ``torch.func``, the SKI interpolation matrix
and covariances, and the NUFFT with its models.  Both packages get the
same numpy inputs from seeded generators.

Tolerances: the exact LOS tables equal bit for bit (the port's indices
int64, the reference's int32); values, jvps and vjps within 1e-12
relative (the same arithmetic in another summation order); the NUFFT
within 1e-12 of the maximum (the same taps and FFT sizes); a JAX vjp of a
complex output equals torch's vjp of the conjugate cotangent.
"""

import jax
import numpy as np
import pytest
import torch
from jax import numpy as jnp

import nifty_tpu.los as jlos
import nifty_tpu.ski as jski
from nifty_tpu.ops import nufft as jnufft
import nifty_tpu_torch as nt
from nifty_tpu_torch import extra
from nifty_tpu_torch.los import los_tables
from nifty_tpu_torch.ops import nufft as tnufft
from nifty_tpu_torch.ops.gather_reduce import GatherReduce, GatherReduceT, PaddedSparse
from nifty_tpu_torch.ops.ndimage import map_coordinates
from nifty_tpu_torch.utils.tree import ShapeWithDtype

torch.set_num_threads(1)
CPU = dict(device="cpu", dtype=torch.float64)
RTOL = 1e-12


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _np(t):
    return t.detach().numpy()


def _close(a, b, rtol=RTOL):
    a, b = np.asarray(a), np.asarray(b)
    np.testing.assert_allclose(a, b, rtol=rtol, atol=rtol * max(np.abs(b).max(), 1e-300))


def _rays(n, shape, dist, seed, sigmas=False):
    rng = np.random.default_rng(seed)
    extent = np.array(shape) * np.array(dist)
    starts = rng.uniform(0.05, 0.95, (n, len(shape))) * extent
    ends = rng.uniform(0.05, 0.95, (n, len(shape))) * extent
    if not sigmas:
        return starts, ends, None
    lengths = np.linalg.norm(ends - starts, axis=1)
    return starts, ends, rng.uniform(0.05, 0.2, n) / lengths


LOS_CASES = {
    "2d": ((16, 24), (0.9 / 16, 1.1 / 24), False),
    "2d_sigmas": ((16, 24), (0.9 / 16, 1.1 / 24), True),
    "3d": ((6, 7, 8), (1.0 / 6, 0.8 / 7, 1.2 / 8), False),
    "3d_sigmas": ((6, 7, 8), (1.0 / 6, 0.8 / 7, 1.2 / 8), True),
}


@pytest.mark.parametrize("case", sorted(LOS_CASES))
def test_exact_los_tables_equal_the_reference(case):
    """The same traversal: the padded tables equal JAX's bit for bit, the
    indices as int64."""
    shape, dist, sig = LOS_CASES[case]
    starts, ends, sigmas = _rays(11, shape, dist, 3, sig)
    idx, wgt = los_tables(starts, ends, shape=shape, distances=dist, sigmas=sigmas)
    ref = jlos.ExactGridLOS(starts, ends, shape=shape, distances=dist, sigmas=sigmas)
    assert idx.dtype == np.int64 and wgt.dtype == np.float32
    np.testing.assert_array_equal(idx, np.asarray(ref.idx).astype(np.int64))
    np.testing.assert_array_equal(wgt, np.asarray(ref.wgt))
    los = nt.ExactGridLOS(starts, ends, shape=shape, distances=dist, sigmas=sigmas, **CPU)
    assert los.table.idx.dtype == torch.int64
    np.testing.assert_array_equal(los.table.idx.numpy(), idx)


@pytest.mark.parametrize("case", sorted(LOS_CASES))
def test_exact_los_value_jvp_vjp(case):
    shape, dist, sig = LOS_CASES[case]
    starts, ends, sigmas = _rays(11, shape, dist, 4, sig)
    rng = np.random.default_rng(5)
    x, t, c = rng.standard_normal(shape), rng.standard_normal(shape), rng.standard_normal(11)
    ref = jlos.ExactGridLOS(starts, ends, shape=shape, distances=dist, sigmas=sigmas)
    los = nt.ExactGridLOS(starts, ends, shape=shape, distances=dist, sigmas=sigmas, **CPU)
    y_j, jt_j = jax.jvp(ref, (jnp.asarray(x),), (jnp.asarray(t),))
    y_t, jt_t = torch.func.jvp(los, (_t(x),), (_t(t),))
    _close(_np(y_t), y_j)
    _close(_np(jt_t), jt_j)
    _close(_np(torch.func.vjp(los, _t(x))[1](_t(c))[0]), jax.vjp(ref, jnp.asarray(x))[1](jnp.asarray(c))[0])
    extra.check_linear_model(los, ShapeWithDtype(shape, torch.float64), 7, rtol=1e-12,
                             device="cpu")


@pytest.mark.parametrize("form", ["shared_start", "shared_end", "a_pair_a_ray"])
@pytest.mark.parametrize("order", [0, 1])
def test_sampling_los_forms(form, order):
    """The three broadcast forms of the endpoints, values, jvp and vjp."""
    shape, dist = (20, 17), (1.0 / 20, 1.0 / 17)
    rng = np.random.default_rng(6)
    starts, ends = rng.uniform(0.1, 0.9, (5, 2)), rng.uniform(0.1, 0.9, (5, 2))
    if form == "shared_start":
        starts = starts[0]
    elif form == "shared_end":
        ends = ends[0]
    kw = dict(shape=shape, distances=dist, n_sampling_points=64, interpolation_order=order)
    ref = jlos.SamplingCartesianGridLOS(starts, ends, **kw)
    los = nt.SamplingCartesianGridLOS(starts, ends, **kw, **CPU)
    x, t, c = rng.standard_normal(shape), rng.standard_normal(shape), rng.standard_normal(5)
    y_j, jt_j = jax.jvp(ref, (jnp.asarray(x),), (jnp.asarray(t),))
    y_t, jt_t = torch.func.jvp(los, (_t(x),), (_t(t),))
    assert tuple(y_t.shape) == tuple(y_j.shape) == (5,)
    _close(_np(y_t), y_j)
    _close(_np(jt_t), jt_j)
    _close(_np(torch.func.vjp(los, _t(x))[1](_t(c))[0]), jax.vjp(ref, jnp.asarray(x))[1](jnp.asarray(c))[0])


def test_exact_los_against_sampled_los():
    """The two discretisations of one integral on a smooth field, at
    ``tests/test_responses.py``'s tolerance (2e-2)."""
    shape, dist = (64, 64), (1.0 / 64, 1.0 / 64)
    xg = (np.arange(64) + 0.5) / 64
    field = _t(np.sin(2 * np.pi * xg)[:, None] * np.cos(np.pi * xg)[None, :])
    starts = np.array([[0.15, 0.2], [0.7, 0.8], [0.1, 0.9]])
    ends = np.array([[0.85, 0.75], [0.2, 0.3], [0.9, 0.1]])
    a = nt.ExactGridLOS(starts, ends, shape=shape, distances=dist, **CPU)(field)
    b = nt.SamplingCartesianGridLOS(starts, ends, shape=shape, distances=dist,
                                    n_sampling_points=4000, **CPU)(field)
    np.testing.assert_allclose(_np(a), _np(b), atol=2e-2, rtol=2e-2)


# --- map_coordinates: JAX's semantics at the edges ------------------------------


EDGE = np.array([-1.0, -0.5, -0.25, 0.0, 0.5, 2.5, 3.0, 3.5, 4.0, 4.5, 7.25, -3.75])


@pytest.mark.parametrize("mode,cval", [("constant", 0.0), ("constant", np.nan),
                                       ("constant", 2.5), ("wrap", 0.0)])
@pytest.mark.parametrize("order", [0, 1])
def test_map_coordinates_matches_jax_at_the_edges(order, mode, cval):
    """Points on, inside and outside both edges of a 4×5 grid: the values
    (NaN where JAX gives NaN, even at weight 0), the gradient in the field
    and, for order 1, in the coordinates."""
    from jax.scipy.ndimage import map_coordinates as jmc

    rng = np.random.default_rng(9)
    img = rng.standard_normal((4, 5))
    coords = np.stack([EDGE, rng.permutation(EDGE) + 0.5])
    ref = np.asarray(jmc(jnp.asarray(img), list(jnp.asarray(coords)), order, mode=mode, cval=cval))
    got = _np(map_coordinates(_t(img), _t(coords), order, mode=mode, cval=cval))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
    assert np.isnan(ref).any() == (np.isnan(cval) and mode == "constant")
    if order == 1 and np.isnan(cval):  # the upper corner of 3.0 lies outside, at weight 0
        assert np.isnan(got[EDGE == 3.0]).all()
    _close(np.nan_to_num(got), np.nan_to_num(ref))
    w = rng.standard_normal(coords.shape[1])

    def loss_j(x, c):
        return jnp.nansum(w * jmc(x, list(c), order, mode=mode, cval=cval))

    def loss_t(x, c):
        return torch.nansum(_t(w) * map_coordinates(x, c, order, mode=mode, cval=cval))

    gx_j, gc_j = jax.grad(loss_j, argnums=(0, 1))(jnp.asarray(img), jnp.asarray(coords))
    gx_t, gc_t = torch.func.grad(loss_t, argnums=(0, 1))(_t(img), _t(coords))
    _close(_np(gx_t), gx_j)
    np.testing.assert_array_equal(np.isnan(_np(gc_t)), np.isnan(np.asarray(gc_j)))
    _close(np.nan_to_num(_np(gc_t)), np.nan_to_num(np.asarray(gc_j)))


def test_map_coordinates_wrap_is_index_mod_size():
    """``wrap`` has period ``size`` (scipy's grid-wrap), one period out
    equals the point itself."""
    x = _t(np.random.default_rng(1).standard_normal(8))
    out = _np(map_coordinates(x, _t(np.array([[0.0, 8.0, 7.5, -0.5]])), 1, mode="wrap"))
    np.testing.assert_allclose(out[1], out[0], atol=1e-15)
    np.testing.assert_allclose(out[2], out[3], atol=1e-15)
    np.testing.assert_allclose(out[2], 0.5 * float(x[-1] + x[0]), atol=1e-15)


# --- the gather-reduce Function --------------------------------------------------


def _table(seed=0, rows=13, width=7, n_cols=40):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, n_cols, (rows, width))
    wgt = rng.standard_normal((rows, width))
    wgt[:, -2:] = 0.0  # padding
    wgt[3, :] = 0.0  # an empty row
    return idx, wgt, PaddedSparse(idx, wgt, n_cols, **CPU)


def test_gather_reduce_against_the_dense_matrix_and_under_vmap():
    """``A x`` and ``Aᵀ y`` against the dense matrix (repeated columns add
    up), the transposed table against its definition, and both Functions
    under ``torch.func.vmap`` (a batch in one gather) against a loop, with
    their jvps and vjps."""
    idx, wgt, a = _table()
    dense = np.zeros(a.shape)
    np.add.at(dense, (np.repeat(np.arange(idx.shape[0]), idx.shape[1]), idx.ravel()), wgt.ravel())
    np.testing.assert_array_equal(_np(a.todense()), dense)
    rng = np.random.default_rng(1)
    xs, ys = _t(rng.standard_normal((4, 40))), _t(rng.standard_normal((4, 13)))
    _close(_np(a @ xs[0]), dense @ _np(xs[0]))
    _close(_np(a.T @ ys[0]), dense.T @ _np(ys[0]))
    for fn, arg in ((lambda x: a @ x, xs), (lambda y: a.T @ y, ys)):
        loop = torch.stack([fn(v) for v in arg])
        np.testing.assert_array_equal(_np(torch.func.vmap(fn)(arg)), _np(loop))
        _, jt = torch.func.vmap(lambda v, t: torch.func.jvp(fn, (v,), (t,)))(arg, arg.flip(0))
        np.testing.assert_array_equal(_np(jt), _np(torch.stack([fn(v) for v in arg.flip(0)])))
    vj = torch.func.vmap(lambda y: torch.func.vjp(lambda x: a @ x, xs[0])[1](y)[0])(ys)
    _close(_np(vj), _np(ys) @ dense)
    # a leading batch (the Functions' own) equals the vmapped batch, and a
    # matrix's columns the same batch
    np.testing.assert_array_equal(_np(GatherReduce.apply(xs, a)),
                                  _np(torch.func.vmap(lambda x: a @ x)(xs)))
    np.testing.assert_array_equal(_np(GatherReduceT.apply(ys, a)),
                                  _np(torch.func.vmap(lambda y: a.T @ y)(ys)))
    np.testing.assert_array_equal(_np(a @ xs.T), _np(GatherReduce.apply(xs, a)).T)
    _close(_np(a.T @ ys.T), dense.T @ _np(ys).T)


def test_gather_reduce_complex_and_adjoint():
    """Complex inputs take real weights; ⟨y, A x⟩ = ⟨Aᵀ y, x⟩."""
    _, _, a = _table(2)
    rng = np.random.default_rng(3)
    x = _t(rng.standard_normal(40) + 1j * rng.standard_normal(40))
    y = _t(rng.standard_normal(13) + 1j * rng.standard_normal(13))
    _close(_np(a @ x), _np(a @ x.real) + 1j * _np(a @ x.imag))
    _close(complex(torch.vdot(y, a @ x)), complex(torch.vdot(a.T @ y, x)))


# --- SKI ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [np.float64, np.complex128])
def test_matmul_toeplitz(dtype):
    rng = np.random.default_rng(0)
    c = rng.standard_normal(17).astype(dtype)
    if dtype == np.complex128:
        c = c + 1j * rng.standard_normal(17)
    x = rng.standard_normal((17, 3))
    _close(_np(nt.matmul_toeplitz(_t(c), _t(x))), jski.matmul_toeplitz(jnp.asarray(c), jnp.asarray(x)))
    _close(_np(nt.matmul_toeplitz(_t(c), _t(x[:, 0]))),
           jski.matmul_toeplitz(jnp.asarray(c), jnp.asarray(x[:, 0])))


@pytest.mark.parametrize("ndim", [1, 2, 3])
def test_interp_mat_todense_matches_the_reference(ndim):
    """Points inside, on the upper edge (clipped corners add up) and on grid
    nodes; by ``grid_bounds`` and by ``distances``."""
    shape = (6, 5, 4)[:ndim]
    rng = np.random.default_rng(ndim)
    pts = rng.uniform(0.0, 1.0, (ndim, 30))
    pts[:, 0] = 1.0 - 1e-12
    pts[:, 1] = 0.5
    bounds = [(0.0, 1.0)] * ndim
    ref = np.asarray(jski.interp_mat(shape, bounds, pts).todense())
    np.testing.assert_array_equal(_np(nt.interp_mat(shape, bounds, pts, **CPU).todense()), ref)
    d = np.full(ndim, 0.3)
    ref_d = np.asarray(jski.interp_mat(shape, None, pts, distances=d).todense())
    np.testing.assert_array_equal(_np(nt.interp_mat(shape, None, pts, distances=d, **CPU).todense()),
                                  ref_d)


@pytest.mark.parametrize("shape", [(32,), (16, 16)])
def test_harmonic_ski_matches_the_reference(shape):
    """``evaluate`` (``torch.func.vmap`` over the identity), the apply and
    the correlated field."""
    ndim = len(shape)
    pts = np.random.default_rng(4).uniform(0.1, 0.9, (ndim, 20))
    bounds = [(0.0, 1.0)] * ndim
    ref = jski.HarmonicSKI(shape, bounds, pts, harmonic_kernel=lambda k: 1.0 / (1.0 + (k / 5.0) ** 2) ** 2)
    ski = nt.HarmonicSKI(shape, bounds, pts, harmonic_kernel=lambda k: 1.0 / (1.0 + (k / 5.0) ** 2) ** 2,
                         **CPU)
    _close(_np(ski.evaluate()), ref.evaluate())
    x = np.random.default_rng(5).standard_normal(20)
    _close(_np(ski(_t(x))), ref(jnp.asarray(x)))
    xi = np.random.default_rng(6).standard_normal(ski.grid_shape)
    _close(_np(ski.correlated_field(_t(xi))), ref.correlated_field(jnp.asarray(xi)))


def test_toeplitz_ski_matches_the_reference():
    pts = np.random.default_rng(3).uniform(0.1, 0.9, (1, 25))
    ref = jski.ToeplitzSKI((64,), [(0.0, 1.0)], pts, kernel=lambda r: jnp.exp(-0.5 * (r / 0.2) ** 2))
    ski = nt.ToeplitzSKI((64,), [(0.0, 1.0)], pts, kernel=lambda r: torch.exp(-0.5 * (r / 0.2) ** 2),
                         **CPU)
    _close(_np(ski.evaluate()), ref.evaluate())
    ski_nj = nt.ToeplitzSKI((64,), [(0.0, 1.0)], pts, kernel=lambda r: torch.exp(-0.5 * (r / 0.2) ** 2),
                            jitter=False, **CPU)
    d = np.abs(pts[0][:, None] - pts[0][None, :])
    np.testing.assert_allclose(_np(ski_nj.evaluate()), np.exp(-0.5 * (d / 0.2) ** 2), atol=0.01)


def test_toeplitz_ski_refuses_more_than_one_axis():
    """On a raveled 2-D grid the kernel matrix is block-Toeplitz: the JAX
    package's 1-D product gives another covariance than the dense kernel
    (a fault of the reference), the port refuses the grid."""
    pts = np.random.default_rng(3).uniform(0.1, 0.9, (2, 6))
    kern = lambda r: jnp.exp(-0.5 * (r / 0.2) ** 2)  # noqa: E731
    cov = np.asarray(jski.ToeplitzSKI((8, 8), [(0.0, 1.0)] * 2, pts, kernel=kern, jitter=False).evaluate())
    w = np.asarray(jski.interp_mat((8, 8), [(0.0, 1.0)] * 2, pts).todense())
    g = np.stack(np.meshgrid(np.arange(8) / 8, np.arange(8) / 8, indexing="ij"), -1).reshape(-1, 2)
    dense = w @ np.exp(-0.5 * (np.linalg.norm(g[:, None] - g[None], axis=-1) / 0.2) ** 2) @ w.T
    assert np.abs(cov - dense).max() > 0.1
    with pytest.raises(ValueError):
        nt.ToeplitzSKI((8, 8), [(0.0, 1.0)] * 2, pts, kernel=torch.exp, **CPU)


# --- NUFFT ---------------------------------------------------------------------------


@pytest.mark.parametrize("cplx", [False, True])
@pytest.mark.parametrize("shape", [(16,), (12, 10)])
def test_nufft2_and_adjoint_match_the_reference(shape, cplx):
    """Type 2 and its adjoint (type 1) against the JAX package's; the port's
    adjoint against the inner-product identity too."""
    ndim = len(shape)
    rng = np.random.default_rng(6)
    x = rng.standard_normal(shape) + (1j * rng.standard_normal(shape) if cplx else 0)
    coords = rng.uniform(-0.5, 0.5, (ndim, 12))
    y = rng.standard_normal(12) + 1j * rng.standard_normal(12)
    ref = np.asarray(jnufft.nufft2(jnp.asarray(x), jnp.asarray(coords)))
    got = _np(nt.nufft2(_t(x), _t(coords)))
    _close(got, ref)
    ref_a = np.asarray(jnufft.nufft_adjoint(jnp.asarray(y), jnp.asarray(coords), shape))
    got_a = _np(nt.nufft_adjoint(_t(y), _t(coords), shape))
    assert got_a.dtype == np.complex128
    _close(got_a, ref_a)
    _close(np.vdot(y, got), np.vdot(got_a, x))
    _close(_np(nt.nufft1(_t(y), _t(coords), shape, kernel_width=8)),
           jnufft.nufft1(jnp.asarray(y), jnp.asarray(coords), shape, kernel_width=8))


def test_nufft2_against_a_direct_dft():
    """``tests/test_responses.py``'s accuracy: 5e-5 of the maximum at the
    default width."""
    rng = np.random.default_rng(6)
    x = rng.standard_normal((16, 16))
    coords = rng.uniform(-0.5, 0.5, (2, 12))
    ii, jj = np.meshgrid(np.arange(16) - 8, np.arange(16) - 8, indexing="ij")
    direct = np.array([np.sum(x * np.exp(-2j * np.pi * (c0 * ii + c1 * jj))) for c0, c1 in coords.T])
    np.testing.assert_allclose(_np(nt.nufft2(_t(x), _t(coords))), direct,
                               atol=5e-5 * np.abs(direct).max())


def test_nufft2_gradient_in_coords_matches_the_reference():
    x = np.random.default_rng(8).standard_normal(16)
    coords = np.array([[0.1, 0.2, -0.3, 0.0]])
    g_j = jax.grad(lambda c: jnp.sum(jnp.abs(jnufft.nufft2(jnp.asarray(x), c)) ** 2))(jnp.asarray(coords))
    g_t = torch.func.grad(lambda c: (nt.nufft2(_t(x), c).abs() ** 2).sum())(_t(coords))
    assert np.isfinite(_np(g_t)).all()
    _close(_np(g_t), g_j, rtol=1e-10)


def test_variable_position_nufft_matches_the_reference():
    """The two-key domain in JAX's (sorted) order, values and the gradient
    of a real loss in both keys."""
    ref = jnufft.VariablePositionNufft((16, 16), npoints=12)
    vp = tnufft.VariablePositionNufft((16, 16), npoints=12)
    assert list(vp.domain) == sorted(ref.domain) == ["nufftcoord", "nufftgrid"]
    rng = np.random.default_rng(2)
    p = {"nufftcoord": rng.uniform(-0.4, 0.4, (2, 12)), "nufftgrid": rng.standard_normal((16, 16))}
    pt = nt.position_from_numpy(vp, p, **CPU)
    pj = {k: jnp.asarray(v) for k, v in p.items()}
    _close(_np(vp(pt)), ref(pj))
    g_j = jax.grad(lambda q: jnp.sum(jnp.abs(ref(q)) ** 2))(pj)
    g_t = torch.func.grad(lambda q: (vp(q).abs() ** 2).sum())(pt)
    for k in p:
        _close(_np(g_t[k]), g_j[k], rtol=1e-10)


def test_shifted_position_fft_matches_the_reference():
    """Zero shift is the FFT (the window edge sits on the bins: the gradient
    stays finite), and a shift of one bin along axis 0 lands on the
    neighbouring frequency; values and gradients against JAX."""
    ref = jnufft.ShiftedPositionFFT((8, 6))
    sp = tnufft.ShiftedPositionFFT((8, 6))
    assert list(sp.domain) == sorted(ref.domain)
    g = np.random.default_rng(0).standard_normal((8, 6))
    for delta in (np.zeros((2, 8, 6)), np.zeros((2, 8, 6)) + np.array([1.0, 0.0])[:, None, None],
                  np.random.default_rng(1).uniform(-0.5, 0.5, (2, 8, 6))):
        pj = {"spfftdelta_coord": jnp.asarray(delta), "spfftgrid": jnp.asarray(g)}
        pt = {"spfftdelta_coord": _t(delta), "spfftgrid": _t(g)}
        _close(_np(sp(pt)), ref(pj), rtol=1e-11)
        g_j = jax.grad(lambda q: jnp.sum(jnp.abs(ref(q)) ** 2))(pj)
        g_t = torch.func.grad(lambda q: (sp(q).abs() ** 2).sum())(pt)
        for k in pt:
            assert np.isfinite(_np(g_t[k])).all()
            _close(_np(g_t[k]), g_j[k], rtol=1e-10)
    out = _np(sp({"spfftdelta_coord": torch.zeros(2, 8, 6, dtype=torch.float64), "spfftgrid": _t(g)}))
    np.testing.assert_allclose(out, np.fft.fftn(g), atol=2e-5 * np.abs(np.fft.fftn(g)).max())
