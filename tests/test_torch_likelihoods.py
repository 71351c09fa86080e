"""Port parity: the likelihoods of ``nifty_tpu_torch/likelihood_impl.py``,
``LikelihoodSum``, the base class's square roots on complex
transformations, and the complex-data ``Gaussian``.

Both packages get the same numpy data, positions and tangents: energy,
metric, LSM, RSM, ``normalized_residual`` and ``transformation`` (where the
JAX package has them), on real and, where it allows, complex data.  Each
likelihood is composed with a small model of a dict position (two keys,
one of them frozen in a second case) and one MGVI residual is drawn with
the JAX package's white noise handed in; a geoVI update follows for the
tree-shaped data spaces.  Float64 on the CPU, tolerance 1e-10: the same
arithmetic, summed in other orders, and four CG iterations on a
four-parameter problem.
"""

import jax
import numpy as np
import pytest
import torch
from jax import numpy as jnp
from jax import random
from torch.utils._pytree import tree_leaves

import nifty_tpu as nj
import nifty_tpu_torch as nt
from nifty_tpu.utils.tree import random_like as jax_random_like

torch.set_num_threads(1)
TOL = 1e-10
N = 12


def _close(got, want, tol=TOL):
    g = [np.asarray(x) for x in tree_leaves(got)]
    w = [np.asarray(x) for x in jax.tree_util.tree_leaves(want)]
    assert len(g) == len(w)
    for a, b in zip(g, w):
        assert a.shape == b.shape and np.iscomplexobj(a) == np.iscomplexobj(b), (a.dtype, b.dtype)
        np.testing.assert_allclose(a, b, rtol=tol, atol=tol * max(np.abs(b).max(), 1.0))


def _t(tree):
    """A numpy tree (an array, a pair, a dict) → the port's, through
    ``position_from_numpy`` with the tree's own shapes and dtypes as its
    domain."""
    domain = jax.tree_util.tree_map(
        lambda a: nt.ShapeWithDtype(a.shape, torch.from_numpy(np.asarray(a)).dtype), tree)
    return nt.position_from_numpy(domain, tree, device="cpu")


def _j(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _rng(seed):
    return np.random.default_rng(seed)


def _cplx(rng, shape):
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


# --- the cases: (JAX likelihood, port likelihood, primals, parameter tangents, data tangents)


def _gaussian(cplx):
    rng = _rng(0)
    draw = (lambda s: _cplx(rng, s)) if cplx else rng.standard_normal
    data, prim, tan, dtan = draw(N), draw(N), draw(N), draw(N)
    w = rng.uniform(0.5, 2.0, N)
    return (nj.Gaussian(jnp.asarray(data), noise_cov_inv=jnp.asarray(w)),
            nt.Gaussian(torch.from_numpy(data), noise_cov_inv=torch.from_numpy(w)), prim, tan, dtan)


def _gaussian_callable():
    rng = _rng(1)
    data, prim, tan, dtan = (rng.standard_normal(N) for _ in range(4))
    return (nj.Gaussian(jnp.asarray(data), noise_std_inv=lambda x: x / 0.3),
            nt.Gaussian(torch.from_numpy(data), noise_std_inv=lambda x: x / 0.3), prim, tan, dtan)


def _student_t(cplx, dof_array):
    rng = _rng(2)
    draw = (lambda s: _cplx(rng, s)) if cplx else rng.standard_normal
    data, prim, tan, dtan = draw(N), draw(N), draw(N), draw(N)
    dof = rng.uniform(2.0, 6.0, N) if dof_array else 3.5
    dj, dt = (jnp.asarray(dof), torch.from_numpy(dof)) if dof_array else (dof, dof)
    return (nj.StudentT(jnp.asarray(data), dj, noise_std_inv=1.3),
            nt.StudentT(torch.from_numpy(data), dt, noise_std_inv=1.3), prim, tan, dtan)


def _bernoulli():
    rng = _rng(3)
    data = rng.integers(0, 2, N)
    prim = rng.uniform(0.1, 0.9, N)
    return (nj.Bernoulli(jnp.asarray(data)), nt.Bernoulli(torch.from_numpy(data)), prim,
            rng.standard_normal(N), rng.standard_normal(N))


def _vcg(cplx):
    rng = _rng(4)
    draw = (lambda s: _cplx(rng, s)) if cplx else rng.standard_normal
    data = draw(N)
    prim = (draw(N), rng.uniform(0.5, 2.0, N))
    tan = (draw(N), rng.standard_normal(N))
    dtan = (draw(N), rng.standard_normal(N))
    return (nj.VariableCovarianceGaussian(jnp.asarray(data)),
            nt.VariableCovarianceGaussian(torch.from_numpy(data)), prim, tan, dtan)


def _vcst():
    rng = _rng(5)
    data = rng.standard_normal(N)
    prim = (rng.standard_normal(N), rng.uniform(0.5, 2.0, N))
    tan = (rng.standard_normal(N), rng.standard_normal(N))
    dtan = (rng.standard_normal(N), rng.standard_normal(N))
    return (nj.VariableCovarianceStudentT(jnp.asarray(data), 4.0),
            nt.VariableCovarianceStudentT(torch.from_numpy(data), 4.0), prim, tan, dtan)


def _categorical():
    rng = _rng(6)
    data = rng.integers(0, 4, (6, 1))
    prim = rng.standard_normal((6, 4))
    return (nj.Categorical(jnp.asarray(data)), nt.Categorical(torch.from_numpy(data)), prim,
            rng.standard_normal((6, 4)), rng.standard_normal((6, 1)))


def _inverse_gamma(alpha_array):
    rng = _rng(7)
    beta = rng.uniform(0.5, 2.0, N)
    alpha = rng.uniform(-0.5, 2.0, N) if alpha_array else -0.5
    aj, at = (jnp.asarray(alpha), torch.from_numpy(alpha)) if alpha_array else (alpha, alpha)
    return (nj.InverseGamma(jnp.asarray(beta), aj), nt.InverseGamma(torch.from_numpy(beta), at),
            rng.uniform(0.5, 2.0, N), rng.standard_normal(N), rng.standard_normal(N))


CASES = {
    "gaussian": lambda: _gaussian(False),
    "gaussian_complex": lambda: _gaussian(True),
    "gaussian_callable": _gaussian_callable,
    "student_t": lambda: _student_t(False, False),
    "student_t_complex_dof_array": lambda: _student_t(True, True),
    "bernoulli": _bernoulli,
    "vcg": lambda: _vcg(False),
    "vcg_complex": lambda: _vcg(True),
    "vc_student_t": _vcst,
    "categorical": _categorical,
    "inverse_gamma": lambda: _inverse_gamma(False),
    "inverse_gamma_alpha_array": lambda: _inverse_gamma(True),
}
NO_TRAFO = {"vc_student_t", "categorical"}
NO_RESIDUAL = {"categorical"}


@pytest.mark.parametrize("case", sorted(CASES))
def test_likelihood_matches_jax(case):
    """Energy, metric, LSM, RSM, normalized residual and transformation."""
    lj, lt, prim, tan, dtan = CASES[case]()
    pj, pt = _j(prim), _t(prim)
    e_t = lt.energy(pt)
    assert e_t.dtype == torch.float64
    np.testing.assert_allclose(float(e_t), float(lj.energy(pj)), rtol=TOL)
    _close(lt.metric(pt, _t(tan)), lj.metric(pj, _j(tan)))
    _close(lt.left_sqrt_metric(pt, _t(dtan)), lj.left_sqrt_metric(pj, _j(dtan)))
    _close(lt.right_sqrt_metric(pt, _t(tan)), lj.right_sqrt_metric(pj, _j(tan)))
    if case not in NO_RESIDUAL:
        _close(lt.normalized_residual(pt), lj.normalized_residual(pj))
    if case not in NO_TRAFO:
        _close(lt.transformation(pt), lj.transformation(pj))
    shp_j = jax.tree_util.tree_leaves(lj.lsm_tangents_shape)
    shp_t = tree_leaves(lt.lsm_tangents_shape, is_leaf=lambda x: isinstance(x, nt.ShapeWithDtype))
    assert [s.shape for s in shp_t] == [tuple(s.shape) for s in shp_j]
    assert [s.dtype is not None and s.dtype.is_complex for s in shp_t] == [
        bool(jnp.issubdtype(s.dtype, jnp.complexfloating)) for s in shp_j]


def test_complex_gaussian_energy_repaired():
    """The energy on complex data is ½ Re (d-f)ᴴ N⁻¹ (d-f), a real number
    (8 points, N⁻¹ = 2)."""
    rng = _rng(11)
    d, f = _cplx(rng, 8), _cplx(rng, 8)
    want = float(nj.Gaussian(jnp.asarray(d), noise_cov_inv=2.0).energy(jnp.asarray(f)))
    got = nt.Gaussian(torch.from_numpy(d), noise_cov_inv=2.0).energy(torch.from_numpy(f))
    assert not got.is_complex()
    np.testing.assert_allclose(float(got), want, rtol=TOL)
    np.testing.assert_allclose(float(got), float(np.vdot(d - f, 2.0 * (d - f)).real) / 2, rtol=TOL)


def test_white_noise_draws_complex_data_noise():
    """``white_noise`` draws complex normals for complex data, real and
    imaginary parts each of variance ½ (the JAX package's law); the prior
    side stays in the position's dtype.  40,000 draws: each variance within
    0.012 of ½ (five standard errors, √(2/n)·½)."""
    n = 40_000
    lh = nt.Gaussian(torch.zeros(n, dtype=torch.complex128)).amend(
        nt.Model(lambda x: x["x"].to(torch.complex128), domain={"x": nt.ShapeWithDtype((n,))}))
    w = nt.white_noise(lh, nt.position_from_numpy(lh.forward_model, {"x": np.zeros(n)},
                                                  device="cpu", dtype=torch.float64), 3)
    assert w.data.dtype == torch.complex128 and w.prior["x"].dtype == torch.float64
    np.testing.assert_allclose([float(w.data.real.var()), float(w.data.imag.var())], 0.5, atol=0.012)
    jw = jax_random_like(random.PRNGKey(0), nj.ShapeWithDtype((n,), jnp.complex128))
    np.testing.assert_allclose([float(jw.real.var()), float(jw.imag.var())], 0.5, atol=0.012)
    pois = nt.Poissonian(torch.zeros(4, dtype=torch.int64)).amend(
        nt.Model(lambda x: x["x"], domain={"x": nt.ShapeWithDtype((4,))}))
    assert nt.white_noise(pois, {"x": torch.ones(4, dtype=torch.float32)}, 3).data.dtype == torch.float32


# --- the base class on complex transformations ------------------------------------------


class _ComplexJ(nj.Likelihood):
    def __init__(self, c, complex_domain):
        dt = jnp.complex128 if complex_domain else jnp.float64
        super().__init__(domain=nj.ShapeWithDtype(c.shape, dt),
                         lsm_tangents_shape=nj.ShapeWithDtype(c.shape, jnp.complex128))
        self.c = jnp.asarray(c)

    def transformation(self, x):
        return self.c * x + 1j * x**2 if not jnp.iscomplexobj(x) else self.c * x + x**2


class _ComplexT(nt.Likelihood):
    def __init__(self, c):
        super().__init__()
        self.c = torch.from_numpy(c)

    @property
    def lsm_tangents_shape(self):
        return nt.ShapeWithDtype(tuple(self.c.shape), torch.complex128)

    def transformation(self, x):
        return self.c * x + 1j * x**2 if not x.is_complex() else self.c * x + x**2


@pytest.mark.parametrize("complex_domain", [False, True])
def test_base_square_roots_on_complex_transformations(complex_domain):
    """The base class's LSM (the vjp of the transformation) and RSM (the
    LSM's transpose) against the JAX package's conjugated pair, for a
    real-to-complex and a complex (holomorphic) transformation."""
    rng = _rng(12)
    c = _cplx(rng, 6)
    draw = (lambda: _cplx(rng, 6)) if complex_domain else (lambda: rng.standard_normal(6))
    x, v, t = draw(), draw(), _cplx(rng, 6)
    lj, lt = _ComplexJ(c, complex_domain), _ComplexT(c)
    _close(lt.left_sqrt_metric(_t(x), _t(t)), lj.left_sqrt_metric(_j(x), _j(t)))
    _close(lt.right_sqrt_metric(_t(x), _t(v)), lj.right_sqrt_metric(_j(x), _j(v)))
    _close(lt.metric(_t(x), _t(v)), lj.metric(_j(x), _j(v)))


# --- with a model: sums, point estimates, the samplers --------------------------------------


def _model_pair(case):
    """A model of ``{"x": (4,), "y": (2,)}`` onto the case's primals, in both
    packages."""
    rng = _rng(20)
    a, b = rng.standard_normal((2 * N, 6)) / 2, rng.standard_normal((N, 6)) / 2

    def make(A, B, sigmoid, exp, cat):
        def lin(x, m, rows=N):
            return m[:rows] @ cat([x["x"], x["y"]])

        if case in ("gaussian_complex", "student_t_complex_dof_array"):
            return lambda x: lin(x, A) + 1j * lin(x, B)
        if case.startswith(("gaussian", "student_t")):
            return lambda x: lin(x, A)
        if case == "bernoulli":
            return lambda x: sigmoid(lin(x, A))
        if case == "vcg_complex":
            return lambda x: (lin(x, A) + 1j * lin(x, B), exp(0.3 * lin(x, B)))
        if case in ("vcg", "vc_student_t"):
            return lambda x: (lin(x, A), exp(0.3 * lin(x, B)))
        if case == "categorical":
            return lambda x: lin(x, A, 2 * N).reshape(6, 4)
        if case.startswith("inverse_gamma"):
            return lambda x: exp(0.3 * lin(x, A))
        raise KeyError(case)

    fj = make(jnp.asarray(a), jnp.asarray(b), jax.nn.sigmoid, jnp.exp, jnp.concatenate)
    ft = make(torch.from_numpy(a), torch.from_numpy(b), torch.sigmoid, torch.exp, torch.cat)
    dom_j = {"x": nj.ShapeWithDtype((4,), jnp.float64), "y": nj.ShapeWithDtype((2,), jnp.float64)}
    dom_t = {"x": nt.ShapeWithDtype((4,)), "y": nt.ShapeWithDtype((2,))}
    pos = {"x": rng.standard_normal(4), "y": rng.standard_normal(2)}
    return nj.Model(fj, domain=dom_j), nt.Model(ft, domain=dom_t), pos


def _amended(case):
    """``(JAX likelihood, port likelihood, the JAX position, the port's)``
    of the case composed with its model; the port's position through
    ``position_from_numpy`` against the model's domain."""
    lj, lt, *_ = CASES[case]()
    mj, mt, pos = _model_pair(case)
    return lj.amend(mj), lt.amend(mt), _j(pos), nt.position_from_numpy(
        mt, pos, device="cpu", dtype=torch.float64)


def _sum_pair():
    lj1, lt1, pj, pt = _amended("gaussian")
    lj2, lt2, _, _ = _amended("bernoulli")
    lj3, lt3, _, _ = _amended("vcg")
    return lj1 + lj2 + lj3, lt1 + (lt2 + lt3), pj, pt


def _jax_white(lhj, pj, key, point_estimates=()):
    """The JAX package's draws inside ``draw_linear_residual`` (the key
    split in two: data-space, then latent), as the port's WhiteNoise."""
    lh, p_liquid = lhj.freeze(point_estimates=point_estimates, primals=pj)
    k_nll, k_prr = random.split(key, 2)
    data = jax_random_like(k_nll, lh.left_sqrt_metric_tangents_shape)
    prior = jax_random_like(k_prr, p_liquid)
    liquid = [k for k in sorted(pj) if k not in point_estimates]
    prior = dict(zip(liquid, jax.tree_util.tree_leaves(prior)))
    to_t = lambda x: torch.from_numpy(np.array(x))  # noqa: E731
    return nt.WhiteNoise(jax.tree_util.tree_map(to_t, data), {k: to_t(v) for k, v in prior.items()})


def test_likelihood_sum_matches_jax():
    """A sum of three (nested: flattened) with tree-shaped data spaces joined
    under ``lh_i``: everything of ``test_likelihood_matches_jax``."""
    lj, lt, pj, pt = _sum_pair()
    assert len(lt.likelihood_summands) == 3
    rng = _rng(21)
    tan = {k: rng.standard_normal(v.shape) for k, v in pt.items()}
    dtan = jax.tree_util.tree_map(lambda s: rng.standard_normal(s.shape), lj.lsm_tangents_shape)
    assert sorted(dtan) == sorted(lt.lsm_tangents_shape) == ["lh_0", "lh_1", "lh_2"]
    np.testing.assert_allclose(float(lt.energy(pt)), float(lj.energy(pj)), rtol=TOL)
    _close(lt.metric(pt, _t(tan)), lj.metric(pj, _j(tan)))
    _close(lt.left_sqrt_metric(pt, _t(dtan)), lj.left_sqrt_metric(pj, _j(dtan)))
    _close(lt.right_sqrt_metric(pt, _t(tan)), lj.right_sqrt_metric(pj, _j(tan)))
    _close(lt.normalized_residual(pt), lj.normalized_residual(pj))
    _close(lt.transformation(pt), lj.transformation(pj))
    with pytest.raises(TypeError):
        nt.LikelihoodSum(lt, lambda x: x)


SAMPLER_CASES = sorted(c for c in CASES if c != "gaussian_callable") + ["sum"]


@pytest.mark.parametrize("point_estimates", [(), ("y",)])
@pytest.mark.parametrize("case", SAMPLER_CASES)
def test_draw_linear_residual_matches_jax(case, point_estimates):
    """One MGVI residual (CG 4) from the JAX package's draws, with and
    without ``y`` frozen (``LikelihoodPartial``), and the metric sample."""
    lj, lt, pj, pt = _sum_pair() if case == "sum" else _amended(case)
    key = random.PRNGKey(5)
    kw = dict(point_estimates=point_estimates, cg_kwargs=dict(maxiter=4, miniter=4, resnorm=-1.0))
    liquid = [k for k in sorted(pt) if k not in point_estimates]
    sj, _ = nj.draw_linear_residual(lj, pj, key, **kw)
    st, _ = nt.draw_linear_residual(lt, pt, white=_jax_white(lj, pj, key, point_estimates), **kw)
    _close({k: st[k] for k in liquid}, {k: sj[k] for k in liquid})
    assert all(not st[k].any() for k in point_estimates)
    mj, _ = nj.draw_linear_residual(lj, pj, key, from_inverse=False, **kw)
    mt, _ = nt.draw_linear_residual(lt, pt, white=_jax_white(lj, pj, key, point_estimates),
                                    from_inverse=False, **kw)
    _close({k: mt[k] for k in liquid}, {k: mj[k] for k in liquid})


@pytest.mark.parametrize("case", ["vcg_complex", "sum", "inverse_gamma", "bernoulli"])
def test_nonlinearly_update_residual_matches_jax(case):
    """geoVI's update (Newton-CG 2 steps of CG 4) of the same linear
    residual, its metric sample from the same draws; the variable-covariance
    and summed likelihoods have tuple- and dict-shaped data spaces."""
    lj, lt, pj, pt = _sum_pair() if case == "sum" else _amended(case)
    key = random.PRNGKey(6)
    white = _jax_white(lj, pj, key)
    residual = {k: 0.3 * v.numpy() for k, v in white.prior.items()}
    mk = dict(maxiter=2, xtol=-1.0, cg_kwargs=dict(maxiter=4, miniter=4, resnorm=-1.0))
    rj, oj = nj.nonlinearly_update_residual(lj, pj, _j(residual), metric_sample_key=key,
                                            minimize_kwargs=mk)
    rt, ot = nt.nonlinearly_update_residual(lt, pt, _t(residual), white=white, minimize_kwargs=mk)
    np.testing.assert_allclose(float(ot.fun), float(oj.fun), rtol=1e-8)
    _close(rt, dict(rj), tol=1e-8)


@pytest.mark.parametrize("case", ["student_t", "vcg", "bernoulli", "inverse_gamma", "sum"])
def test_optimize_kl_runs(case):
    """Two geoVI iterations of ``optimize_kl`` (vmap, 2 mirrored samples):
    the samples and the position stay finite.  (The categorical likelihood
    has no normalized residual for the status report, in either package.)"""
    _, lt, _, pt = _sum_pair() if case == "sum" else _amended(case)
    samples, state = nt.optimize_kl(
        lt, pt, key=torch.Generator().manual_seed(1), n_total_iterations=2, n_samples=1,
        draw_linear_kwargs=dict(cg_kwargs=dict(maxiter=4)),
        nonlinearly_update_kwargs=dict(minimize_kwargs=dict(maxiter=2, cg_kwargs=dict(maxiter=4))),
        kl_kwargs=dict(minimize_kwargs=dict(maxiter=2, cg_kwargs=dict(maxiter=4))))
    assert len(samples) == 2
    for s in list(samples) + [samples.pos]:
        assert all(bool(torch.isfinite(v).all()) for v in s.values())
    assert np.isfinite(float(state.minimization_state.fun))


def test_nuts_sample_with_a_likelihood():
    """``nuts_sample`` takes a ``Likelihood`` and samples its standardized
    posterior (``LogDensity``): ``tests/test_hmc.py``'s conjugate model with
    numpy draws, 2 chains of 300 samples after 200 warm-up steps.  The
    posterior mean within five Monte-Carlo errors (the effective sample
    size from ``get_sample_size_estimate``), the standard deviation within
    25 %, as there."""
    rng = _rng(5)
    n_dat, n_par, noise_std = 8, 4, 0.5
    a = rng.standard_normal((n_dat, n_par)) / np.sqrt(n_par)
    data = a @ rng.standard_normal(n_par) + noise_std * rng.standard_normal(n_dat)
    at = torch.from_numpy(a)
    model = nt.Model(lambda x: at @ x["x"], domain={"x": nt.ShapeWithDtype((n_par,))})
    lh = nt.Gaussian(torch.from_numpy(data), noise_cov_inv=1.0 / noise_std**2).amend(model)
    samples, info = nt.nuts_sample(
        lh, 8, n_chains=2, n_samples=300, n_warmup=200, max_tree_depth=8,
        position_proto={"x": torch.zeros(n_par, dtype=torch.float64)})
    cov = np.linalg.inv(a.T @ a / noise_std**2 + np.eye(n_par))
    mean = cov @ (a.T @ data / noise_std**2)
    smpl = samples.samples["x"]
    assert smpl.shape == (600, n_par)
    ess = sum(nt.get_sample_size_estimate(info["chain_samples"]["x"][c]).numpy() for c in range(2))
    np.testing.assert_array_less(np.abs(smpl.mean(dim=0).numpy() - mean), 5.0 * np.sqrt(np.diag(cov) / ess))
    np.testing.assert_allclose(smpl.std(dim=0).numpy(), np.sqrt(np.diag(cov)), rtol=0.25)
    assert np.all(info["acceptance"].numpy() > 0.5)
    with pytest.raises(ValueError, match="position_proto"):
        nt.nuts_sample(lh.likelihood, 8, n_samples=1, n_warmup=0)
