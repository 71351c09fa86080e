"""Port parity: parametric VI (``variational_models.py``), the
``torch.optim`` bridge (``optimize.optim_wrapper``, ``minimize``'s
``"optim"`` and ``"l-bfgs"``), ``partial_insert_and_remove`` and
``amend(..., likelihood_argnames=)``.

``MeanFieldVI`` and ``FullCovarianceVI``: the loss and its gradient at the
JAX package's own normal draws (each ``random.split`` key's draws handed
to the port as its draw source), and 5 Adam steps against the JAX
package's ``fit`` (``optax.adam(1e-2)``, the same draws a step): torch's
Adam and optax's compute m̂ / (√v̂ + ε) alike.  The bridge: Adam on
``tests/test_solvers.py:199``'s quadratic step for step against
``optax_wrapper`` (the same iterates and iteration count); L-BFGS on its
Rosenbrock function (``:191``), where the two line searches differ, to
the same minimum.  Float64 on the CPU; tolerance 1e-10 unless a test says
otherwise.
"""

import jax
import numpy as np
import optax
import pytest
import torch
from jax import numpy as jnp
from jax import random

import nifty_tpu as nj
import nifty_tpu_torch as nt
from nifty_tpu.optimize import minimize as jax_minimize

torch.set_num_threads(1)
TOL = 1e-10
DIM, NDATA = 6, 20


def _close(got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * max(np.abs(want).max(), 1.0))


def _problem():
    """Demo 12's kind of model: tanh of a linear map of two latent keys,
    under Gaussian noise; both packages get the same matrix and data."""
    rng = np.random.default_rng(0)
    A = rng.standard_normal((NDATA, DIM + 2)) / np.sqrt(DIM)
    data = np.tanh(A @ rng.standard_normal(DIM + 2)) + 0.05 * rng.standard_normal(NDATA)

    def fwd_j(p):
        p = p.tree if hasattr(p, "tree") else p
        return jnp.tanh(jnp.asarray(A) @ jnp.concatenate([p["x"], p["y"]]))

    def fwd_t(p):
        return torch.tanh(torch.from_numpy(A) @ torch.cat([p["x"], p["y"]]))

    lj = nj.Gaussian(jnp.asarray(data), noise_cov_inv=lambda x: x / 0.05**2).amend(fwd_j)
    lt = nt.Gaussian(data, noise_cov_inv=1.0 / 0.05**2, device="cpu").amend(fwd_t)
    pos = {"x": 0.1 * rng.standard_normal(DIM), "y": 0.1 * rng.standard_normal(2)}
    return lj, lt, pos


def _jax_draws(key, n, size):
    return np.asarray(jax.vmap(lambda k: random.normal(k, (size,), jnp.float64))(
        random.split(key, n)))


def _vis(cls_name):
    lj, lt, pos = _problem()
    vj = getattr(nj, cls_name)(lj, {k: jnp.asarray(v) for k, v in pos.items()}, n_samples=3)
    vt = getattr(nt, cls_name)(lt, {k: torch.from_numpy(v) for k, v in pos.items()}, n_samples=3)
    return vj, vt


def _perturbed_params(vj, vt, seed):
    rng = np.random.default_rng(seed)
    params = {k: np.asarray(v) + 0.05 * rng.standard_normal(v.shape) for k, v in vj.params.items()}
    return params, nt.params_from_numpy(vt, params)


@pytest.mark.parametrize("cls_name", ["MeanFieldVI", "FullCovarianceVI"])
def test_loss_and_gradient(cls_name):
    vj, vt = _vis(cls_name)
    assert {k: tuple(v.shape) for k, v in vt.params.items()} == {
        k: tuple(v.shape) for k, v in vj.params.items()}
    params_np, params_t = _perturbed_params(vj, vt, 1)
    params_j = {k: jnp.asarray(v) for k, v in params_np.items()}
    key = random.PRNGKey(3)
    eps = torch.from_numpy(_jax_draws(key, 3, DIM + 2))
    lj, gj = jax.value_and_grad(vj.loss)(params_j, key)
    lt, gt = torch.func.grad_and_value(vt.loss)(params_t, eps)[::-1]
    _close(float(lt), float(lj))
    for k in gj:
        _close(gt[k], gj[k])
    _close(vt.sample(params_t, eps[0])["x"], vj.sample(params_j, random.split(key, 3)[0])["x"])
    _close(float(vt.entropy(params_t)), float(vj.entropy(params_j)))


@pytest.mark.parametrize("cls_name", ["MeanFieldVI", "FullCovarianceVI"])
def test_adam_steps_match_optax(cls_name):
    vj, vt = _vis(cls_name)
    key = random.PRNGKey(7)
    keys, k = [], key
    for _ in range(5):  # the JAX fit's key sequence: key, sk = split(key)
        k, sk = random.split(k)
        keys.append(sk)
    draws = [torch.from_numpy(_jax_draws(sk, 3, DIM + 2)) for sk in keys]
    losses_j, losses_t = [], []
    pj = vj.fit(key, n_steps=5, callback=lambda i, p, loss: losses_j.append(loss))
    pt = vt.fit(lambda i: draws[i], n_steps=5, callback=lambda i, p, loss: losses_t.append(loss))
    _close(losses_t, losses_j)
    for k_ in pj:
        _close(pt[k_], pj[k_], tol=1e-9)  # Adam divides by √v̂ + 1e-8
    for name in ("mean",) + (("std",) if cls_name == "MeanFieldVI" else ()):
        got, want = getattr(vt, name), getattr(vj, name)
        for leaf in ("x", "y"):
            _close(got[leaf], want[leaf], tol=1e-9)
    if cls_name == "FullCovarianceVI":
        _close(vt.covariance(), vj.covariance(), tol=1e-9)
    smpls = vt.posterior_samples(11, 4)
    assert smpls.samples["x"].shape == (4, DIM) and len(smpls) == 4


def test_fit_runs_from_a_seed():
    _, vt = _vis("MeanFieldVI")
    losses = []
    vt.fit(5, n_steps=30, callback=lambda i, p, loss: losses.append(loss))
    assert np.all(np.isfinite(losses)) and np.mean(losses[-5:]) < np.mean(losses[:5])


def test_optim_bridge_adam_matches_optax_wrapper():
    def qj(x):
        return jnp.sum((x - 2.0) ** 2)

    def qt(x):
        return torch.sum((x - 2.0) ** 2)

    opts = dict(maxiter=2000, xtol=1e-7)
    rj = jax_minimize(qj, jnp.zeros(4), method="optax",
                      options=dict(optimizer=optax.adam(0.2), **opts))
    rt = nt.minimize(qt, torch.zeros(4, dtype=torch.float64), method="optim",
                     options=dict(optimizer=lambda ps: torch.optim.Adam(ps, lr=0.2), **opts))
    assert int(rt.nit) == int(rj.nit)
    _close(rt.x, rj.x)
    _close(float(rt.fun), float(rj.fun), tol=1e-8)
    np.testing.assert_allclose(rt.x.numpy(), 2.0, atol=1e-3)
    # the same through fun_and_grad and through jac
    rg = nt.optim_wrapper(fun_and_grad=lambda x: (qt(x), 2 * (x - 2.0)),
                          x0=torch.zeros(4, dtype=torch.float64),
                          optimizer=lambda ps: torch.optim.Adam(ps, lr=0.2), **opts)
    _close(rg.x, rj.x)
    assert int(rg.nit) == int(rj.nit)


def test_optim_bridge_lbfgs_matches_optax_wrapper():
    def rosen_j(x):
        return jnp.sum(100.0 * (x[1:] - x[:-1] ** 2) ** 2 + (1 - x[:-1]) ** 2)

    def rosen_t(x):
        return torch.sum(100.0 * (x[1:] - x[:-1] ** 2) ** 2 + (1 - x[:-1]) ** 2)

    opts = dict(maxiter=500, xtol=1e-10)
    rj = jax_minimize(rosen_j, jnp.zeros(6), method="l-bfgs", options=opts)
    rt = nt.minimize(rosen_t, torch.zeros(6, dtype=torch.float64), method="l-bfgs", options=opts)
    # the same minimum; the line searches differ, so the iterates do not
    np.testing.assert_allclose(np.asarray(rj.x), 1.0, atol=1e-5)
    np.testing.assert_allclose(rt.x.numpy(), 1.0, atol=1e-5)
    assert int(rt.nit) < 500 and float(rt.fun) < 1e-10
    # a dict position
    rd = nt.minimize(lambda p: rosen_t(torch.cat([p["a"], p["b"]])),
                     {"a": torch.zeros(3, dtype=torch.float64), "b": torch.zeros(3, dtype=torch.float64)},
                     method="l-bfgs", options=opts)
    np.testing.assert_allclose(torch.cat([rd.x["a"], rd.x["b"]]).numpy(), 1.0, atol=1e-5)


def test_partial_insert_and_remove():
    from nifty_tpu.likelihood import partial_insert_and_remove as jpir

    # keys in sorted order: the JAX package's trees flatten dicts by sorted
    # key, the port's (torch's pytrees) by insertion
    def fj(a, b):
        return {"c": jnp.sum(a["v"]), "d": a["u"] - b, "s": a["u"] * b + a["v"]}

    def ft(a, b):
        return {"c": torch.sum(a["v"]), "d": a["u"] - b, "s": a["u"] * b + a["v"]}

    rng = np.random.default_rng(5)
    u, v, b = rng.standard_normal(4), rng.standard_normal(4), rng.standard_normal(4)
    insert = ({"u": True, "v": False}, None)
    remove = {"c": False, "d": True, "s": False}
    gj = jpir(fj, insert, ((jnp.asarray(u),), None), remove_axes=remove)
    gt = nt.partial_insert_and_remove(ft, insert, ((torch.from_numpy(u),), None), remove_axes=remove)
    want = gj((jnp.asarray(v),), jnp.asarray(b))
    got = gt((torch.from_numpy(v),), torch.from_numpy(b))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        _close(g, w)
    # a liquid argument given as a dict of the other leaves, in any key order
    got = nt.partial_insert_and_remove(ft, insert, ((torch.from_numpy(u),), None))(
        {"v": torch.from_numpy(v)}, torch.from_numpy(b))
    _close(got["d"], np.asarray(fj({"u": jnp.asarray(u), "v": jnp.asarray(v)}, jnp.asarray(b))["d"]))
    # nothing inserted: the function itself (the JAX package's ``any(insert_axes)``
    # raises for a Vector position, ROADMAP C.3)
    assert nt.partial_insert_and_remove(ft, (None, None), (None, None)) is ft
    # the removed leaves rebuilt by ``unflatten``
    g2 = nt.partial_insert_and_remove(ft, None, None, remove_axes=remove,
                                      unflatten=lambda kept: {"c": kept[0], "s": kept[1]})
    out = g2({"u": torch.from_numpy(u), "v": torch.from_numpy(v)}, torch.from_numpy(b))
    assert set(out) == {"s", "c"}


class _ScaledGaussianJ(nj.Likelihood):
    def __init__(self, data):
        self.data = data
        shape = nj.ShapeWithDtype(data.shape)
        super().__init__(domain=shape, lsm_tangents_shape=shape)

    def energy(self, x, scale=1.0):
        return 0.5 * jnp.sum((self.data - x) ** 2) / scale**2

    def transformation(self, x, scale=1.0):
        return x / scale


class _ScaledGaussianT(nt.Likelihood):
    def __init__(self, data):
        super().__init__()
        self.register_buffer("data", data)

    def energy(self, x, scale=1.0):
        return 0.5 * torch.sum((self.data - x) ** 2) / scale**2

    def transformation(self, x, scale=1.0):
        return x / scale


def test_likelihood_argnames():
    rng = np.random.default_rng(6)
    data, x, t = rng.standard_normal(5), rng.standard_normal(3), rng.standard_normal(3)
    A = rng.standard_normal((5, 3))
    lj = _ScaledGaussianJ(jnp.asarray(data)).amend(
        lambda p, shift=0.0: jnp.asarray(A) @ p + shift, likelihood_argnames=("scale",))
    lt = _ScaledGaussianT(torch.from_numpy(data)).amend(
        lambda p, shift=0.0: torch.from_numpy(A) @ p + shift, likelihood_argnames=("scale",))
    kw = dict(scale=1.7, shift=0.3)
    _close(float(lt.energy(torch.from_numpy(x), **kw)), float(lj.energy(jnp.asarray(x), **kw)))
    _close(lt.metric(torch.from_numpy(x), torch.from_numpy(t), **kw),
           lj.metric(jnp.asarray(x), jnp.asarray(t), **kw))
    _close(lt.transformation(torch.from_numpy(x), **kw), lj.transformation(jnp.asarray(x), **kw))
    # a second amend keeps the names; its inner model takes the other keywords
    B = rng.standard_normal((3, 3))
    lj2 = lj.amend(lambda p, shift=0.0: jnp.asarray(B) @ p)
    lt2 = lt.amend(lambda p, shift=0.0: torch.from_numpy(B) @ p)
    assert lt2.likelihood_argnames == ("scale",)
    _close(float(lt2.energy(torch.from_numpy(x), scale=0.8)),
           float(lj2.energy(jnp.asarray(x), scale=0.8)))
