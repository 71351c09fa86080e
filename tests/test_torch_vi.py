"""Port parity: the solvers and the MGVI/geoVI loop.

Both packages get the same numpy-made systems, positions, data, samples
and white-noise draws (jax keys and torch generators give different
streams, so the JAX package's draws are handed to the port).  Float64 on
the CPU.  Tolerances, and why:

- CG and Newton-CG iterates, MGVI and geoVI residuals, the sample-averaged
  KL, its gradient and metric: relative 1e-8 of max|ref| per leaf.  The
  algorithms are the same; summation orders differ, and a few CG
  iterations on an ill-conditioned metric amplify double rounding by a
  few orders (more iterations amplify it without bound once CG has
  converged on part of the spectrum, so the solves here stop early);
- float32 CG (the question whether the port's f32 CG departs from the JAX
  package's): iterates within 1e-3 relative through 5 iterations, f32
  rounding times the growth above;
- the analytic-covariance check: the MC error of 1500 samples, as in
  ``tests/test_evi.py``; the demo's NRMSE < 0.3, as ``demos/0_intro.py``
  asserts in its fast schedule.
"""

import pickle

import jax
import numpy as np
import pytest
import torch
from jax import numpy as jnp
from jax import random

import nifty_tpu as nj
import nifty_tpu_torch as nt
from nifty_tpu.optimize_kl import _kl_met as jax_kl_met
from nifty_tpu.optimize_kl import _kl_vg as jax_kl_vg
from nifty_tpu.utils.tree import random_like as jax_random_like
from nifty_tpu_torch import conjugate_gradient
from nifty_tpu_torch.optimize_kl import _kl_met, _kl_vg

torch.set_num_threads(1)
RTOL = 1e-8


def _close(a, b, rtol=RTOL):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    np.testing.assert_allclose(a, b, rtol=rtol, atol=rtol * max(np.abs(b).max(), 1e-300))


def _close_tree(got, want, rtol=RTOL):
    want = want.tree if isinstance(want, nj.Vector) else want
    assert set(got) == set(want)
    for k in want:
        _close(got[k].numpy(), want[k], rtol)


def _np(tree):
    tree = tree.tree if isinstance(tree, nj.Vector) else tree
    return {k: np.array(v) for k, v in tree.items()}


# --- CG ------------------------------------------------------------------------


def _spd_system(seed=0, shift=3.0):
    """A dict-of-arrays SPD system: 10 + 4×5 unknowns."""
    rng = np.random.default_rng(seed)
    Q = rng.standard_normal((30, 30))
    A = Q @ Q.T / 30 + shift * np.eye(30)
    b = rng.standard_normal(30)
    split = lambda v, m: {"a": v[:10], "b": v[10:].reshape(4, 5)}  # noqa: E731

    def mat_j(x):
        return split(jnp.asarray(A) @ jnp.concatenate([x["a"], x["b"].ravel()]), None)

    At = torch.from_numpy(A)

    def mat_t(x):
        return split(At @ torch.cat([x["a"], x["b"].reshape(-1)]), None)

    bn = split(b, None)
    return A, mat_j, mat_t, bn


CG_CASES = {
    "fixed_count": dict(maxiter=7, miniter=7, resnorm=-1.0),
    "resnorm": dict(maxiter=40, tol=1e-6),
    "absdelta": dict(maxiter=30, absdelta=1e-5, miniter=3),
    "from_x0": dict(maxiter=9, miniter=9, resnorm=-1.0),
    "reset_at_20": dict(maxiter=22, miniter=22, resnorm=-1.0),
}


@pytest.mark.parametrize("case", sorted(CG_CASES))
def test_static_cg_matches_jax(case):
    """Iterates, iteration count and info code of the port's static_cg and
    the JAX package's, on the same dict-of-arrays SPD system."""
    _, mat_j, mat_t, b = _spd_system(1, shift=0.3 if case == "reset_at_20" else 3.0)
    kw = dict(CG_CASES[case])
    x0 = {k: 0.1 * np.ones_like(v) for k, v in b.items()} if case == "from_x0" else None
    rj = nj.static_cg(mat_j, {k: jnp.asarray(v) for k, v in b.items()},
                      x0=None if x0 is None else {k: jnp.asarray(v) for k, v in x0.items()}, **kw)
    rt = nt.static_cg(mat_t, {k: torch.from_numpy(v) for k, v in b.items()},
                      x0=None if x0 is None else {k: torch.from_numpy(v) for k, v in x0.items()}, **kw)
    assert (int(rt.nit), int(rt.info)) == (int(rj.nit), int(rj.info))
    _close_tree(rt.x, rj.x)


@pytest.mark.parametrize("raise_nonposdef", [False, True])
def test_static_cg_info_on_negative_curvature(raise_nonposdef):
    """A negative-definite matrix: the JAX package's info code (0, or -1
    under ``_raise_nonposdef``) and its iterate."""
    A, mat_j, mat_t, b = _spd_system(2)
    neg_j = lambda x: {k: -v for k, v in mat_j(x).items()}  # noqa: E731
    neg_t = lambda x: {k: -v for k, v in mat_t(x).items()}  # noqa: E731
    kw = dict(maxiter=10, _raise_nonposdef=raise_nonposdef)
    rj = nj.static_cg(neg_j, {k: jnp.asarray(v) for k, v in b.items()}, **kw)
    rt = nt.static_cg(neg_t, {k: torch.from_numpy(v) for k, v in b.items()}, **kw)
    assert (int(rt.nit), int(rt.info)) == (int(rj.nit), int(rj.info)) == (1, -1 if raise_nonposdef else 0)
    _close_tree(rt.x, rj.x)


def test_static_cg_reads_the_host_rarely():
    """Converged after a few iterations of a limit of 200, static_cg runs at
    most SYNC_EVERY products past the stop before it reads the flag, and
    those change nothing."""
    _, _, mat_t, b = _spd_system(3, shift=30.0)
    calls = []

    def mat(x):
        calls.append(1)
        return mat_t(x)

    bt = {k: torch.from_numpy(v) for k, v in b.items()}
    res = nt.static_cg(mat, bt, maxiter=200, tol=1e-6)
    nit = int(res.nit)
    assert int(res.info) == 0 and nit < 10
    assert nit < len(calls) <= nit + conjugate_gradient.SYNC_EVERY
    ref = nt.static_cg(mat_t, bt, maxiter=nit, miniter=nit, resnorm=-1.0)
    _close_tree(res.x, {k: v.numpy() for k, v in ref.x.items()}, 1e-14)


def _bench_field(pkg, shape, knots=None, dtype=torch.float64):
    """``bench.py``'s correlated field (``bench.py:78-88``)."""
    cfm = pkg.CorrelatedFieldMaker("cf")
    cfm.set_amplitude_total_offset(offset_mean=1.0, offset_std=(1e-1, 3e-2))
    cfm.add_fluctuations(shape, distances=1.0 / shape[0], fluctuations=(1.0, 5e-1),
                         loglogavgslope=(-3.0, 2e-1), flexibility=(1e0, 2e-1), n_mode_knots=knots)
    return cfm.finalize() if pkg is nj else cfm.finalize(device="cpu", dtype=dtype)


def test_cg_float32_matches_jax():
    """20 host-loop CG iterations on (M + 1) x = b in float32, M the Poisson
    metric of the bench model (``chip_smoke.py`` phase 5 at 64²), in both
    packages: the same iterates to f32 rounding through 5 iterations, and
    the same course of the residual (up after the first iteration, then
    below it).  The f32 departure from f64 is CG's own, not the port's
    (PERF.md, section 7)."""
    n = 64
    rng = np.random.default_rng(42)
    ct = _bench_field(nt, (n, n), dtype=torch.float32)
    pos = {k: rng.standard_normal(v.shape) for k, v in sorted(ct.domain.items())}
    data = rng.poisson(1.0, size=(n, n)).astype(np.int32)
    rng_t = np.random.default_rng(44)
    tan = {k: rng_t.standard_normal(v.shape) for k, v in sorted(ct.domain.items())}
    lht = nt.Poissonian(torch.from_numpy(data)).amend(nt.ChainModel(torch.exp, ct))
    pt = nt.position_from_numpy(ct, pos)
    bt = nt.position_from_numpy(ct, tan)
    mat_t = lambda x: nt.tree_axpy(1.0, x, lht.metric(pt, x))  # noqa: E731
    ct64 = _bench_field(nt, (n, n))
    lh64 = nt.Poissonian(torch.from_numpy(data)).amend(nt.ChainModel(torch.exp, ct64))
    p64, b64 = nt.position_from_numpy(ct64, pos), nt.position_from_numpy(ct64, tan)

    def residual(x):
        x = {k: torch.as_tensor(np.asarray(v)).double() for k, v in x.items()}
        r = nt.tree_axpy(1.0, x, lh64.metric(p64, x))
        return float(nt.norm({k: r[k] - b64[k] for k in r}) / nt.norm(b64))

    with jax.enable_x64(False):
        cj = _bench_field(nj, (n, n))
        lhj = nj.Poissonian(jnp.asarray(data)).amend(nj.ChainModel(jnp.exp, cj))
        pj = nj.Vector({k: jnp.asarray(v, jnp.float32) for k, v in pos.items()})
        bj = nj.Vector({k: jnp.asarray(v, jnp.float32) for k, v in tan.items()})
        mat_j = jax.jit(lambda x: lhj.metric(pj, x) + x)
        res = {}
        for it in (1, 2, 5, 20):
            kw = dict(maxiter=it, miniter=it, absdelta=0.0)
            xj = _np(nj.cg(mat_j, bj, **kw).x)
            xt = nt.cg(mat_t, bt, **kw).x
            assert all(v.dtype == np.float32 for v in xj.values())
            assert all(v.dtype == torch.float32 for v in xt.values())
            if it <= 5:
                _close_tree(xt, xj, 1e-3)
            res[it] = residual(xj), residual(xt)
    (j1, t1), (j20, t20) = res[1], res[20]
    assert j1 > 1.0 and t1 > 1.0 and abs(j1 - t1) <= 1e-3 * j1
    assert j20 < j1 and t20 < t1


# --- Newton-CG -----------------------------------------------------------------


def _rosen(x, lib):
    return lib.sum(100.0 * (x[1:] - x[:-1] ** 2) ** 2 + (1 - x[:-1]) ** 2)


@pytest.mark.parametrize("maxiter", [1, 3, 30])
@pytest.mark.parametrize("method", ["newton_cg", "static_newton_cg"])
def test_newton_cg_rosenbrock_matches_jax(method, maxiter):
    """Iterates of both Newton-CGs on a Rosenbrock problem (Hessian-vector
    products derived from ``fun``): after 1 and 3 steps and converged."""
    x0 = np.array([-1.2, 1.0, -0.5, 0.8, 1.3])
    kw = dict(maxiter=maxiter, cg_kwargs=dict(maxiter=20))
    rj = getattr(nj, method)(lambda x: _rosen(x, jnp), jnp.asarray(x0), **kw)
    rt = getattr(nt, method)(lambda x: _rosen(x, torch), torch.from_numpy(x0), **kw)
    assert (int(rt.nit), int(rt.status)) == (int(rj.nit), int(rj.status))
    _close(rt.x.numpy(), rj.x)
    _close(float(rt.fun), float(rj.fun))


@pytest.mark.parametrize("method", ["newton_cg", "static_newton_cg"])
def test_newton_cg_quadratic_matches_jax(method):
    """A dict-of-arrays quadratic with its Hessian given as ``hessp`` and
    the energy criterion ``absdelta``."""
    A, mat_j, mat_t, b = _spd_system(4, shift=0.5)
    bj = {k: jnp.asarray(v) for k, v in b.items()}
    bt = {k: torch.from_numpy(v) for k, v in b.items()}

    def vg_j(x):
        ax = mat_j(x)
        e = sum(0.5 * jnp.vdot(x[k], ax[k]) - jnp.vdot(bj[k], x[k]) for k in x)
        return e, nj.Vector({k: ax[k] - bj[k] for k in x})

    def vg_t(x):
        ax = mat_t(x)
        e = sum(0.5 * torch.vdot(x[k].reshape(-1), ax[k].reshape(-1))
                - torch.vdot(bt[k].reshape(-1), x[k].reshape(-1)) for k in x)
        return e, {k: ax[k] - bt[k] for k in x}

    x0 = {k: np.zeros_like(v) for k, v in b.items()}
    kw = dict(maxiter=8, absdelta=1e-9, cg_kwargs=dict(maxiter=4))
    rj = getattr(nj, method)(x0=nj.Vector({k: jnp.asarray(v) for k, v in x0.items()}),
                             fun_and_grad=vg_j, hessp=lambda x, t: nj.Vector(mat_j(t)), **kw)
    rt = getattr(nt, method)(x0={k: torch.from_numpy(v) for k, v in x0.items()},
                             fun_and_grad=vg_t, hessp=lambda x, t: mat_t(t), **kw)
    assert (int(rt.nit), int(rt.status)) == (int(rj.nit), int(rj.status))
    _close_tree(rt.x, rj.x)


# --- samples -------------------------------------------------------------------


def _poisson_pair(shape=(32, 32), knots=8, seed=0):
    cj, ct = _bench_field(nj, shape, knots), _bench_field(nt, shape, knots)
    rng = np.random.default_rng(seed)
    pos = {k: 0.3 * rng.standard_normal(v.shape) for k, v in sorted(ct.domain.items())}
    data = rng.poisson(2.0, size=shape).astype(np.int32)
    lhj = nj.Poissonian(jnp.asarray(data)).amend(nj.ChainModel(jnp.exp, cj))
    lht = nt.Poissonian(torch.from_numpy(data)).amend(nt.ChainModel(torch.exp, ct))
    return lhj, lht, ct, pos


def _jax_white(lhj, pj, key, point_estimates=()):
    """The JAX package's draws inside ``draw_linear_residual(lhj, pj, key)``
    (the key split in two, data-space then latent draws), as the port's
    WhiteNoise of the liquid keys."""
    lh, p_liquid = lhj.freeze(point_estimates=point_estimates, primals=pj)
    k_nll, k_prr = random.split(key, 2)
    data = np.array(jax_random_like(k_nll, lh.left_sqrt_metric_tangents_shape))
    prior = jax_random_like(k_prr, p_liquid)
    liquid = [k for k in sorted(_np(pj)) if k not in point_estimates]
    prior = dict(zip(liquid, (np.array(v) for v in jax.tree_util.tree_leaves(prior))))
    return nt.WhiteNoise(torch.from_numpy(data), {k: torch.from_numpy(v) for k, v in prior.items()})


@pytest.mark.parametrize("point_estimates", [(), ("cfzeromode", "cffluctuations")])
def test_draw_linear_residual_matches_jax(point_estimates):
    """One MGVI residual (6 CG iterations) of the 32² knot-8 Poisson model,
    with and without point estimates, from the JAX package's draws."""
    lhj, lht, ct, pos = _poisson_pair()
    # a dict, not a Vector: the JAX package's point-estimate insertion
    # tests the truth of its arguments, which a Vector refuses
    pj, pt = {k: jnp.asarray(v) for k, v in pos.items()}, nt.position_from_numpy(ct, pos)
    key = random.PRNGKey(3)
    kw = dict(point_estimates=point_estimates, cg_kwargs=dict(maxiter=6, miniter=6, resnorm=-1.0))
    sj, ij = nj.draw_linear_residual(lhj, pj, key, **kw)
    st, it = nt.draw_linear_residual(lht, pt, white=_jax_white(lhj, pj, key, point_estimates), **kw)
    assert int(it) == int(ij) == 6
    liquid = [k for k in pos if k not in point_estimates]
    _close_tree({k: st[k] for k in liquid}, {k: sj[k] for k in liquid})
    assert all(not st[k].any() and st[k].shape == pt[k].shape for k in point_estimates)
    metric_j, _ = nj.draw_linear_residual(lhj, pj, key, from_inverse=False)
    metric_t, info = nt.draw_linear_residual(lht, pt, white=_jax_white(lhj, pj, key), from_inverse=False)
    assert info == 0
    _close_tree(metric_t, metric_j)


@pytest.mark.parametrize("sign", [1.0, -1.0])
def test_nonlinearly_update_residual_matches_jax(sign):
    """geoVI's update with ``bench_extra.py``'s settings (Newton-CG 2
    steps, CG 5) of the same linear residual, metric sample from the same
    draws."""
    lhj, lht, ct, pos = _poisson_pair(seed=1)
    pj, pt = nj.Vector({k: jnp.asarray(v) for k, v in pos.items()}), nt.position_from_numpy(ct, pos)
    key = random.PRNGKey(4)
    residual = {k: np.asarray(0.5 * v) for k, v in _np(_jax_white(lhj, pj, key).prior).items()}
    mk = dict(maxiter=2, xtol=-1.0, cg_kwargs=dict(maxiter=5, miniter=5, resnorm=-1.0))
    rj, oj = nj.nonlinearly_update_residual(
        lhj, pj, nj.Vector({k: jnp.asarray(v) for k, v in residual.items()}),
        metric_sample_key=key, metric_sample_sign=sign, minimize_kwargs=mk)
    rt, ot = nt.nonlinearly_update_residual(
        lht, pt, {k: torch.from_numpy(v) for k, v in residual.items()},
        white=_jax_white(lhj, pj, key), metric_sample_sign=sign, minimize_kwargs=mk)
    assert (int(ot.nit), int(ot.status)) == (int(oj.nit), int(oj.status)) == (2, 2)
    assert ot.x is None and ot.jac is None
    _close(float(ot.fun), float(oj.fun))
    _close_tree(rt, rj)


def test_kl_value_grad_and_metric_match_jax():
    """The sample-averaged KL, its gradient and metric on the same four
    samples (``samples_from_numpy``)."""
    lhj, lht, ct, pos = _poisson_pair(seed=2)
    rng = np.random.default_rng(5)
    res = {k: 0.2 * rng.standard_normal((4,) + v.shape) for k, v in pos.items()}
    tan = {k: rng.standard_normal(v.shape) for k, v in pos.items()}
    sj = nj.Samples(pos=nj.Vector({k: jnp.asarray(v) for k, v in pos.items()}),
                    samples=nj.Vector({k: jnp.asarray(v) for k, v in res.items()}))
    st = nt.samples_from_numpy(ct, pos, res)
    assert len(st) == 4 and st.pos["cfxi"].dtype == torch.float64
    at = {k: 0.9 * v for k, v in pos.items()}
    vj, gj = jax_kl_vg(lhj, nj.Vector({k: jnp.asarray(v) for k, v in at.items()}), sj)
    vt, gt = _kl_vg(lht, nt.position_from_numpy(ct, at), st)
    _close(float(vt), float(vj))
    _close_tree(gt, gj)
    mj = jax_kl_met(lhj, nj.Vector({k: jnp.asarray(v) for k, v in at.items()}),
                    nj.Vector({k: jnp.asarray(v) for k, v in tan.items()}), sj)
    mt = _kl_met(lht, nt.position_from_numpy(ct, at), nt.position_from_numpy(ct, tan), st)
    _close_tree(mt, mj)
    v0j, _ = jax_kl_vg(lhj, sj.pos, nj.Samples(pos=sj.pos, samples=None))
    v0t, _ = _kl_vg(lht, st.pos, nt.Samples(pos=st.pos))
    _close(float(v0t), float(v0j))


def _linear_gaussian(n=6, m=8, seed=0):
    """``tests/test_evi.py``'s linear-Gaussian model and its analytic
    posterior covariance (Rᵀ N⁻¹ R + 1)⁻¹."""
    rng = np.random.default_rng(seed)
    R = rng.normal(size=(m, n))
    noise_cov_inv = np.linalg.inv(np.diag(rng.uniform(0.5, 2.0, size=m)))
    data = rng.normal(size=m)
    Rt, Nt = torch.from_numpy(R), torch.from_numpy(noise_cov_inv)
    fwd = nt.Model(lambda x: Rt @ x["xi"], domain={"xi": nt.ShapeWithDtype((n,))})
    lh = nt.Gaussian(torch.from_numpy(data), noise_cov_inv=lambda x: Nt @ x).amend(fwd)
    return lh, np.linalg.inv(R.T @ noise_cov_inv @ R + np.eye(n))


def test_mgvi_samples_match_analytic_covariance():
    """``tests/test_evi.py::test_mgvi_samples_match_analytic_covariance``,
    ported: 1500 MGVI residuals from integer seeds at a linear-Gaussian
    model have its analytic posterior covariance within MC error."""
    lh, post_cov = _linear_gaussian()
    pos = {"xi": torch.zeros(post_cov.shape[0], dtype=torch.float64)}
    kw = dict(cg_kwargs=dict(resnorm=1e-12, maxiter=200))
    smpls = np.stack([nt.draw_linear_residual(lh, pos, k, **kw)[0]["xi"].numpy() for k in range(1500)])
    np.testing.assert_allclose(np.cov(smpls.T), post_cov, atol=0.12, rtol=0.35)


def test_nonlinear_update_reduces_to_linear_for_gaussian():
    """``tests/test_evi.py``'s check, ported: for a linear model geoVI
    keeps the linear residual."""
    lh, _ = _linear_gaussian()
    pos = {"xi": torch.zeros(6, dtype=torch.float64)}
    resid, _ = nt.draw_linear_residual(lh, pos, 3, cg_kwargs=dict(resnorm=1e-12, maxiter=300))
    curved, _ = nt.nonlinearly_update_residual(
        lh, pos, resid, metric_sample_key=3, metric_sample_sign=1.0,
        minimize_kwargs=dict(maxiter=5, xtol=1e-10))
    np.testing.assert_allclose(curved["xi"].numpy(), resid["xi"].numpy(), rtol=1e-4, atol=1e-5)


def test_white_noise_replays_from_a_key():
    """An integer key draws the same white noise every time (geoVI redraws
    its metric sample from the key of the linear residual); another key
    draws other noise."""
    _, lht, ct, pos = _poisson_pair(shape=(16, 16))
    pt = nt.position_from_numpy(ct, pos)
    a, b, c = (nt.white_noise(lht, pt, k) for k in (7, 7, 8))
    assert a.data.shape == (16, 16) and set(a.prior) == set(pt)
    assert torch.equal(a.data, b.data) and all(torch.equal(a.prior[k], b.prior[k]) for k in pt)
    assert not torch.equal(a.data, c.data)
    s1, _ = nt.draw_linear_residual(lht, pt, 7, cg_kwargs=dict(maxiter=3))
    s2, _ = nt.draw_linear_residual(lht, pt, white=a, cg_kwargs=dict(maxiter=3))
    assert all(torch.equal(s1[k], s2[k]) for k in pt)


def test_samples_container():
    """``tests/test_evi.py::test_samples_container``, ported, with
    ``concatenate_zip`` and ``draw_residual``'s antithetic pair."""
    pos = {"a": torch.zeros(3)}
    s = nt.Samples(pos=pos, samples={"a": torch.stack([torch.ones(3), -torch.ones(3)])})
    assert len(s) == 2
    assert torch.equal(s[0]["a"], torch.ones(3)) and torch.equal(s[1]["a"], -torch.ones(3))
    assert torch.equal(s.at({"a": torch.ones(3)})[1]["a"], torch.zeros(3))
    assert torch.equal(nt.mean(s.samples)["a"], torch.zeros(3))
    assert [float(x["a"][0]) for x in s] == [1.0, -1.0]
    z = nt.concatenate_zip({"a": torch.tensor([1.0, 2.0])}, {"a": torch.tensor([-1.0, -2.0])})
    assert z["a"].tolist() == [1.0, -1.0, 2.0, -2.0]
    lh, _ = _linear_gaussian()
    pair, (plus, minus) = nt.draw_residual(lh, {"xi": torch.zeros(6, dtype=torch.float64)}, 5,
                                           minimize_kwargs=dict(maxiter=3))
    assert pair["xi"].shape == (2, 6) and int(plus.nit) >= 1 and int(minus.nit) >= 1


def test_minisanity_matches_jax():
    rng = np.random.default_rng(6)
    pos = {"a": rng.standard_normal(5), "b": rng.standard_normal((3, 4))}
    res = {k: rng.standard_normal((4,) + v.shape) for k, v in pos.items()}
    sj = nj.Samples(pos={k: jnp.asarray(v) for k, v in pos.items()},
                    samples={k: jnp.asarray(v) for k, v in res.items()})
    st = nt.Samples(pos={k: torch.from_numpy(v) for k, v in pos.items()},
                    samples={k: torch.from_numpy(v) for k, v in res.items()})
    want = nj.reduced_residual_stats(sj, lambda x: x["b"] * 2.0)
    got = nt.reduced_residual_stats(st, lambda x: x["b"] * 2.0)
    _close(got.mean.numpy(), want.mean, 1e-12)
    _close(got.reduced_chisq.numpy(), want.reduced_chisq, 1e-12)
    assert int(got.ndof) == int(want.ndof) == 12
    stats, table = nt.minisanity(st)
    want, _ = nj.minisanity(sj)
    for k in pos:
        _close(stats[k].reduced_chisq.numpy(), want[k].reduced_chisq, 1e-12)
        assert k in table
    one, _ = nt.minisanity(st.pos)
    assert float(one["a"].reduced_chisq[1]) == 0.0  # one position: no spread


# --- the loop ------------------------------------------------------------------


def _intro_demo(seed=42):
    """``demos/0_intro.py``'s 1-D model and data, made with numpy."""
    cfm = nt.CorrelatedFieldMaker("cf")
    cfm.set_amplitude_total_offset(offset_mean=2.0, offset_std=(1e-1, 3e-2))
    cfm.add_fluctuations((128,), distances=1.0 / 128, fluctuations=(1.0, 5e-1),
                         loglogavgslope=(-3.0, 2e-1), flexibility=(1e0, 2e-1),
                         asperity=(5e-1, 5e-2), prefix="ax1", non_parametric_kind="power")
    cf = cfm.finalize(device="cpu", dtype=torch.float64)
    signal = nt.ChainModel(torch.exp, cf)
    rng = np.random.default_rng(seed)
    truth = nt.position_from_numpy(cf, {k: rng.standard_normal(v.shape) for k, v in cf.domain.items()})
    signal_truth = signal(truth)
    data = signal_truth + np.sqrt(0.1) * torch.from_numpy(rng.standard_normal(128))
    lh = nt.Gaussian(data, noise_cov_inv=lambda x: x / 0.1).amend(signal)
    start = nt.position_from_numpy(cf, {k: rng.standard_normal(v.shape) for k, v in cf.domain.items()})
    return lh, signal, signal_truth, start


def _intro_kwargs(delta=1e-4):
    """``demos/0_intro.py``'s fast schedule."""
    return dict(
        n_samples=2,
        draw_linear_kwargs=dict(cg_kwargs=dict(absdelta=delta * 10.0, maxiter=100)),
        nonlinearly_update_kwargs=dict(minimize_kwargs=dict(xtol=delta, maxiter=5)),
        kl_kwargs=dict(minimize_kwargs=dict(xtol=delta, maxiter=35)),
        sample_mode="nonlinear_resample",
    )


def test_optimize_kl_intro_demo():
    """geoVI on ``demos/0_intro.py``'s 1-D setup in its fast schedule (2
    iterations, 2 mirrored sample pairs) reaches its NRMSE < 0.3."""
    lh, signal, truth, start = _intro_demo()
    samples, state = nt.optimize_kl(lh, start, key=torch.Generator().manual_seed(42),
                                    n_total_iterations=2, **_intro_kwargs())
    assert state.nit == 2 and len(samples) == 4 and len(samples.keys) == 2
    assert len(state.sample_state) == 4 and all(int(s.nit) >= 1 for s in state.sample_state)
    post_mean, post_std = nt.mean_and_std([signal(s) for s in samples])
    nrmse = float(torch.sqrt(torch.mean((post_mean - truth) ** 2)) / torch.sqrt(torch.mean(truth**2)))
    assert nrmse < 0.3
    assert torch.all(post_std > 0)


def test_optimize_kl_resume_round_trip(tmp_path):
    """With ``odir`` every iteration writes ``minisanity.txt`` and pickles
    the samples and the state; ``resume`` goes on from the pickle to the
    same result as an uninterrupted run."""
    lh, _, _, start = _intro_demo(seed=3)
    kw = dict(_intro_kwargs(), sample_mode="linear_resample",
              kl_kwargs=dict(minimize_kwargs=dict(xtol=1e-4, maxiter=5)))
    full, full_state = nt.optimize_kl(lh, start, key=torch.Generator().manual_seed(1),
                                      n_total_iterations=2, **kw)
    odir = str(tmp_path / "run")
    nt.optimize_kl(lh, start, key=torch.Generator().manual_seed(1), n_total_iterations=1,
                   odir=odir, **kw)
    assert "OPTIMIZE_KL: Iteration 0001" in (tmp_path / "run" / "minisanity.txt").read_text()
    with open(tmp_path / "run" / "last.pkl", "rb") as f:
        samples, state = pickle.load(f)
    assert state.nit == 1 and state.config == {} and len(samples) == 4
    resumed, state = nt.optimize_kl(lh, start, key=torch.Generator().manual_seed(99),
                                    n_total_iterations=2, odir=odir, resume=True, **kw)
    assert state.nit == 2
    for k in full.pos:
        torch.testing.assert_close(resumed.pos[k], full.pos[k], rtol=1e-12, atol=1e-12)
        torch.testing.assert_close(resumed._samples[k], full._samples[k], rtol=1e-12, atol=1e-12)


def test_update_follows_schedules_and_constants():
    """Schedules as functions of the iteration, point estimates in the
    draws, constants in the KL step, and the status message."""
    lh, _, _, start = _intro_demo(seed=4)
    opt = nt.OptimizeVI(lh, 2)
    state = opt.init_state(
        torch.Generator().manual_seed(0),
        n_samples=lambda i: 1 + i,
        sample_mode=lambda i: "linear_resample" if i == 0 else "nonlinear_update",
        point_estimates=("cfzeromode",),
        constants=("cfax1fluctuations",),
        draw_linear_kwargs=dict(cg_kwargs=dict(maxiter=10)),
        nonlinearly_update_kwargs=dict(minimize_kwargs=dict(maxiter=2, cg_kwargs=dict(maxiter=5))),
        kl_kwargs=dict(minimize_kwargs=dict(maxiter=2)),
    )
    samples, state = opt.update(nt.Samples(pos=start), state)
    assert len(samples) == 2 and not samples._samples["cfzeromode"].any()
    assert torch.equal(samples.pos["cfax1fluctuations"], start["cfax1fluctuations"])
    assert not torch.equal(samples.pos["cfxi"], start["cfxi"])
    assert isinstance(state.sample_state, torch.Tensor)
    msg = opt.get_status_message(samples, state)
    assert "Iteration 0001" in msg and "linear sampling status" in msg
    samples, state = opt.update(samples, state)  # 2 samples now: a fresh nonlinear draw
    assert len(samples) == 4 and len(state.sample_state) == 4


def test_maps_that_are_not_ported_raise():
    lh, _, _, _ = _intro_demo()
    for kw in (dict(kl_map="vmap"), dict(residual_map="vmap"), dict(kl_map="pmap")):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            nt.OptimizeVI(lh, 1, **kw)
    with pytest.raises(NotImplementedError):
        nt.minimize(lambda x: (x**2).sum(), torch.zeros(2), method="trust-ncg")
