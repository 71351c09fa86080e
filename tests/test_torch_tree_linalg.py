"""Port parity: the spectral matrix functions of ``utils/tree_linalg.py``
(``sym_sqrtm``, ``sym_logm``, ``sym_inv``, ``sym_solve``, Daleckii–Krein
derivatives) and ``NDVariableCovarianceGaussian``.

Both packages get the same numpy matrices in float64 on the CPU: values,
jvps and vjps of each function on a batch of symmetric positive-definite
matrices, on a matrix with a repeated eigenvalue (the derivative's
``close`` branch) and on one with a non-positive eigenvalue (projected
out).  The likelihood at ``tests/test_reference_parity.py:282``'s sizes
(5 pixels, d = 3), both ``covariance`` values: energy, metric, LSM,
``transformation``, ``normalized_residual``, and the metric of a model
composed with it (its jvp and vjp through the spectral Function).
Tolerance 1e-10 of max|ref|: the same LAPACK eigensystem and formula.
"""

import jax
import numpy as np
import pytest
import torch
from jax import numpy as jnp
from torch.utils._pytree import tree_leaves

import nifty_tpu as nj
import nifty_tpu_torch as nt
from nifty_tpu.utils import tree_linalg as jtl
from nifty_tpu_torch.utils import tree_linalg as ttl

torch.set_num_threads(1)
TOL = 1e-10


def _close(got, want, tol=TOL):
    g = [np.asarray(x) for x in tree_leaves(got)]
    w = [np.asarray(x) for x in jax.tree_util.tree_leaves(want)]
    assert len(g) == len(w)
    for a, b in zip(g, w):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=tol, atol=tol * max(np.abs(b).max(), 1.0))


def _spd(rng, n, d, shift=2.0):
    m = rng.normal(size=(n, d, d))
    return m @ np.swapaxes(m, -1, -2) + shift * np.eye(d)


def _with_eigenvalues(rng, values):
    q, _ = np.linalg.qr(rng.normal(size=(len(values), len(values))))
    return (q * np.asarray(values)) @ q.T


def _sym(rng, shape):
    t = rng.normal(size=shape)
    return t + np.swapaxes(t, -1, -2)


def _matrices(kind):
    rng = np.random.default_rng({"spd": 0, "repeated": 1, "indefinite": 2}[kind])
    if kind == "spd":
        return _spd(rng, 5, 3)
    if kind == "repeated":
        return np.stack([_with_eigenvalues(rng, [2.0, 2.0, 5.0]),
                         _with_eigenvalues(rng, [1.5, 1.5, 1.5])])
    return np.stack([_with_eigenvalues(rng, [-1.0, 0.5, 3.0]),
                     _with_eigenvalues(rng, [0.0, 2.0, 4.0])])


FUNCS = ["sym_sqrtm", "sym_logm", "sym_inv"]


@pytest.mark.parametrize("kind", ["spd", "repeated", "indefinite"])
@pytest.mark.parametrize("name", FUNCS)
def test_spectral_functions(name, kind):
    M = _matrices(kind)
    dM = _sym(np.random.default_rng(3), M.shape)
    jf, tf = getattr(jtl, name), getattr(ttl, name)
    jy, jdy = jax.jvp(jf, (jnp.asarray(M),), (jnp.asarray(dM),))
    ty, tdy = torch.func.jvp(tf, (torch.from_numpy(M),), (torch.from_numpy(dM),))
    _close(ty, jy)
    _close(tdy, jdy)
    cot = np.random.default_rng(4).normal(size=M.shape)
    jg = jax.vjp(jf, jnp.asarray(M))[1](jnp.asarray(cot))[0]
    tg = torch.func.vjp(tf, torch.from_numpy(M))[1](torch.from_numpy(cot))[0]
    _close(tg, jg)
    x = torch.from_numpy(M).requires_grad_(True)
    (tf(x) * torch.from_numpy(cot)).sum().backward()
    _close(x.grad, jg)


def test_spectral_function_under_vmap():
    M, dM = _matrices("spd"), _sym(np.random.default_rng(5), (5, 3, 3))
    f = lambda m, t: torch.func.jvp(ttl.sym_sqrtm, (m,), (t,))  # noqa: E731
    y, dy = torch.func.vmap(f)(torch.from_numpy(M), torch.from_numpy(dM))
    jy, jdy = jax.vmap(lambda m, t: jax.jvp(jtl.sym_sqrtm, (m,), (t,)))(jnp.asarray(M), jnp.asarray(dM))
    _close((y, dy), (jy, jdy))


@pytest.mark.parametrize("matrix_eqn,transposed", [(False, False), (True, False), (True, True)])
def test_sym_solve(matrix_eqn, transposed):
    rng = np.random.default_rng(6)
    A = _spd(rng, 5, 3)
    B = rng.normal(size=(5, 3, 3) if matrix_eqn else (5, 3))
    kw = dict(matrix_eqn=matrix_eqn, transposed=transposed)
    _close(ttl.sym_solve(torch.from_numpy(A), torch.from_numpy(B), **kw),
           jtl.sym_solve(jnp.asarray(A), jnp.asarray(B), **kw))
    _close(ttl.sym_solve({"a": torch.from_numpy(A)}, {"a": torch.from_numpy(B)}, **kw),
           jtl.sym_solve({"a": jnp.asarray(A)}, {"a": jnp.asarray(B)}, **kw))


def _ndvcg_case(seed, covariance, n=5, d=3):
    rng = np.random.default_rng(seed)
    data = rng.normal(size=(n, d))
    mean, mat = rng.normal(size=(n, d)), _spd(rng, n, d)
    t = (rng.normal(size=(n, d)), _sym(rng, (n, d, d)))
    lj = nj.NDVariableCovarianceGaussian(jnp.asarray(data), covariance=covariance)
    lt = nt.NDVariableCovarianceGaussian(data, covariance=covariance, device="cpu")
    return lj, lt, (mean, mat), t


def _j(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _t(tree):
    return tuple(torch.from_numpy(np.asarray(x)) for x in tree)


@pytest.mark.parametrize("covariance", [True, False])
def test_nd_variable_covariance_gaussian(covariance):
    lj, lt, p, t = _ndvcg_case(7, covariance)
    assert [s.shape for s in lt.domain] == [(5, 3), (5, 3, 3)]
    # the (mean, mat) pair carried across by interop, on its domain
    pair = nt.position_from_numpy(lt.domain, p, device="cpu")
    assert isinstance(pair, tuple) and all(torch.equal(a, b) for a, b in zip(pair, _t(p)))
    _close(float(lt.energy(_t(p))), float(lj.energy(_j(p))))
    _close(lt.metric(_t(p), _t(t)), lj.metric(_j(p), _j(t)))
    _close(lt.left_sqrt_metric(_t(p), _t(t)), lj.left_sqrt_metric(_j(p), _j(t)))
    _close(lt.transformation(_t(p)), lj.transformation(_j(p)))
    _close(lt.normalized_residual(_t(p)), lj.normalized_residual(_j(p)))
    # the energy's gradient pulls through the spectral Function's backward
    gj = jax.grad(lambda q: lj.energy(q))(_j(p))
    gt = torch.func.grad(lambda q: lt.energy(q))(_t(p))
    _close(gt, gj)


@pytest.mark.parametrize("covariance", [True, False])
def test_nd_variable_covariance_gaussian_with_a_model(covariance):
    """(mean, mat) from a dict position: ``mat = exp`` of a symmetric 2×2
    built from three fields (``sym_logm``'s inverse direction through
    ``torch.linalg.matrix_exp``), the metric of the composition."""
    rng = np.random.default_rng(8)
    n = 6
    data = rng.normal(size=(n, 2))

    def fwd_t(x):
        a, b, c = x["a"], x["b"], x["c"]
        s = torch.stack([torch.stack([a, b], -1), torch.stack([b, c], -1)], -2)
        return (x["m"], torch.linalg.matrix_exp(s))

    def fwd_j(x):
        a, b, c = x["a"], x["b"], x["c"]
        s = jnp.stack([jnp.stack([a, b], -1), jnp.stack([b, c], -1)], -2)
        return (x["m"], jax.scipy.linalg.expm(s))

    shapes = {"a": (n,), "b": (n,), "c": (n,), "m": (n, 2)}
    pos = {k: 0.3 * rng.normal(size=s) for k, s in shapes.items()}
    tan = {k: rng.normal(size=s) for k, s in shapes.items()}
    lj = nj.NDVariableCovarianceGaussian(jnp.asarray(data), covariance=covariance).amend(fwd_j)
    lt = nt.NDVariableCovarianceGaussian(data, covariance=covariance, device="cpu").amend(fwd_t)
    tp = {k: torch.from_numpy(v) for k, v in pos.items()}
    tt = {k: torch.from_numpy(v) for k, v in tan.items()}
    jp, jt = nj.Vector({k: jnp.asarray(v) for k, v in pos.items()}), nj.Vector(
        {k: jnp.asarray(v) for k, v in tan.items()})
    m_t, m_j = lt.metric(tp, tt), lj.metric(jp, jt).tree
    _close([m_t[k] for k in sorted(m_t)], [m_j[k] for k in sorted(m_j)])
    _close(float(lt.energy(tp)), float(lj.energy(jp)))


def test_eigh_in_chunks(monkeypatch):
    """The batch split into chunks of ``EIGH_CHUNK`` matrices (the card's
    batched solver refuses 65,536): the same values and jvps as one call,
    against the JAX package."""
    monkeypatch.setattr(ttl, "EIGH_CHUNK", 4)
    M = _spd(np.random.default_rng(9), 11, 2).reshape(11, 1, 2, 2)
    dM = _sym(np.random.default_rng(10), M.shape)
    ty, tdy = torch.func.jvp(ttl.sym_sqrtm, (torch.from_numpy(M),), (torch.from_numpy(dM),))
    jy, jdy = jax.jvp(jtl.sym_sqrtm, (jnp.asarray(M),), (jnp.asarray(dM),))
    _close((ty, tdy), (jy, jdy))
