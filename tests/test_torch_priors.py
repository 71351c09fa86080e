"""Port parity: the prior maps of ``num/stats_distributions.py``, the prior
models of ``models/prior.py`` and the Gauss-Markov processes of
``models/gauss_markov.py``.

Both packages get the same numpy inputs in float64 on the CPU: every
prior family and inverse prior, ``interpolator`` with and without a table
transform, each with its value and its gradient (``jax.grad`` against
``torch.func.grad`` of the summed map), and every Gauss-Markov process
and model with its jvp.  Tolerance 1e-10 (the same arithmetic); the
tabulated maps evaluate the same float64 tables the same way, so they
hold it too, at and between the knots.  One case runs under
``torch.func.vmap``.
"""

import jax
import numpy as np
import pytest
import torch
from jax import numpy as jnp

import nifty_tpu as nj
import nifty_tpu_torch as nt
from nifty_tpu.num import stats_distributions as jsd
from nifty_tpu_torch.num import stats_distributions as tsd

torch.set_num_threads(1)
TOL = 1e-10


def _x(seed=0, n=64):
    """Standard-normal points, a few of them on the table's knots and ends
    (-8.2 + k·0.01) and beyond them."""
    x = np.random.default_rng(seed).standard_normal(n) * 2.5
    return np.concatenate([x, [-8.2, -3.0, 0.0, 1.25, 8.2, -9.0, 9.5]])


def _check(jfn, tfn, x, tol=TOL):
    want = np.asarray(jfn(jnp.asarray(x)))
    got = tfn(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * max(np.nanmax(np.abs(want)), 1.0))
    jg = np.asarray(jax.grad(lambda v: jnp.sum(jfn(v)))(jnp.asarray(x)))
    tg = torch.func.grad(lambda v: torch.sum(tfn(v)))(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(tg, jg, rtol=tol, atol=tol * max(np.nanmax(np.abs(jg)), 1.0))


CLOSED = [
    ("normal_prior", (0.5, 2.0)),
    ("lognormal_prior", (1.5, 0.4)),
    ("laplace_prior", (0.7,)),
    ("uniform_prior", (-1.0, 3.0)),
]


@pytest.mark.parametrize("name,args", CLOSED, ids=[c[0] for c in CLOSED])
def test_closed_form_priors(name, args):
    _check(getattr(jsd, name)(*args), getattr(tsd, name)(*args), _x(1))


@pytest.mark.parametrize("name,args", [("normal_invprior", (0.5, 2.0)),
                                       ("lognormal_invprior", (1.5, 0.4))])
def test_inverse_priors(name, args):
    y = np.abs(_x(2)) + 0.1
    _check(getattr(jsd, name)(*args), getattr(tsd, name)(*args), y)


TABULATED = [
    ("invgamma_prior", (3.0, 2.0), {}),
    ("invgamma_prior", (2.5, 1.5), {"loc": 0.5}),
    ("gamma_prior", (2.0,), {"scale": 1.5}),
    ("gamma_prior", (2.0,), {"scale": 1.5, "loc": 0.3}),
    ("beta_prior", (2.0, 3.0), {}),
    ("loginvgamma_prior", (3.0, 2.0), {}),
]


@pytest.mark.parametrize("name,args,kw", TABULATED,
                         ids=[f"{c[0]}-{'loc' if c[2].get('loc') else 'noloc'}" for c in TABULATED])
def test_tabulated_priors(name, args, kw):
    x = _x(3)
    if name == "beta_prior":
        x = x[np.abs(x) < 8.0]  # the logit table is ±inf at its ends in both packages
    _check(getattr(jsd, name)(*args, **kw), getattr(tsd, name)(*args, **kw), x)


def test_invgamma_invprior():
    y = np.exp(np.random.default_rng(4).standard_normal(40))
    _check(jsd.invgamma_invprior(3.0, 2.0), tsd.invgamma_invprior(3.0, 2.0), y)


@pytest.mark.parametrize("table", [False, True])
def test_interpolator(table):
    f = lambda x: np.sin(x) + 2.0 * x + 10.0  # noqa: E731
    kw = {}
    if table:
        jkw = dict(table_func=jnp.log, inv_table_func=jnp.exp)
        kw = dict(table_func=torch.log, inv_table_func=torch.exp)
    else:
        jkw = {}
    x = np.concatenate([np.linspace(-3.5, 3.5, 57), [-3.0, -2.5, 0.0, 3.0, 2.5]])
    j_f, j_inv = jsd.interpolator(f, -3.0, 3.0, step=0.25, return_inverse=True, **jkw)
    t_f, t_inv = tsd.interpolator(f, -3.0, 3.0, step=0.25, return_inverse=True, **kw)
    _check(j_f, t_f, x)
    _check(j_inv, t_inv, np.linspace(4.5, 15.5, 31))
    _check(jsd.interpolator(f, -3.0, 3.0, num=13, **jkw),
           tsd.interpolator(f, -3.0, 3.0, num=13, **kw), x)


def test_interpolator_tables_stay_float64():
    ip = tsd.invgamma_prior(3.0, 2.0)
    ip.to(torch.float32)
    assert ip.xs.dtype == torch.float64 and ip.ys.dtype == torch.float64
    x = torch.from_numpy(_x(5)).float()
    ref = tsd.invgamma_prior(3.0, 2.0)(x.double())
    assert ip(x).dtype == torch.float32
    np.testing.assert_allclose(ip(x).numpy(), ref.float().numpy(), rtol=0, atol=0)


def test_tabulated_prior_under_vmap():
    x = np.random.default_rng(6).standard_normal((4, 9))
    tfn = tsd.invgamma_prior(3.0, 2.0)
    got = torch.func.vmap(torch.func.grad(lambda v: tfn(v).sum()))(torch.from_numpy(x))
    jfn = jsd.invgamma_prior(3.0, 2.0)
    want = jax.vmap(jax.grad(lambda v: jnp.sum(jfn(v))))(jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


PRIOR_MODELS = [
    ("NormalPrior", (0.5, 2.0), {}),
    ("LogNormalPrior", (1.5, 0.4), {}),
    ("LaplacePrior", (0.7,), {}),
    ("UniformPrior", (-1.0, 3.0), {}),
    ("InvGammaPrior", (3.0, 2.0), {}),
    ("GammaPrior", (2.0,), {"scale": 1.5}),
    ("BetaPrior", (2.0, 3.0), {}),
    ("LogInvGammaPrior", (3.0, 2.0), {}),
]


@pytest.mark.parametrize("name,args,kw", PRIOR_MODELS, ids=[c[0] for c in PRIOR_MODELS])
def test_prior_models(name, args, kw):
    jm = getattr(nj, name)(*args, name="p", shape=(5,), **kw)
    tm = getattr(nt, name)(*args, name="p", shape=(5,), **kw)
    assert set(tm.domain) == {"p"} and tm.domain["p"].shape == (5,)
    assert tm.target.shape == (5,)
    x = np.random.default_rng(7).standard_normal(5)
    np.testing.assert_allclose(tm({"p": torch.from_numpy(x)}).numpy(),
                               np.asarray(jm({"p": jnp.asarray(x)})), rtol=TOL, atol=TOL)
    draw = tm.init(torch.Generator().manual_seed(0), device="cpu")
    assert draw["p"].shape == (5,)
    unnamed = getattr(nt, name)(*args, shape=(3,), **kw)
    assert unnamed.domain.shape == (3,) and unnamed(torch.zeros(3)).shape == (3,)


# --- Gauss-Markov processes ------------------------------------------------------


def _both(jfn, tfn, args_np, tol=TOL):
    jargs = [jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args_np]
    targs = [torch.from_numpy(a) if isinstance(a, np.ndarray) else a for a in args_np]
    want, got = np.asarray(jfn(*jargs)), tfn(*targs).numpy()
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * np.abs(want).max())


def test_wiener_process():
    rng = np.random.default_rng(8)
    xi, dt = rng.standard_normal(37), rng.uniform(0.1, 1.0, 37)
    _both(lambda x, d: nj.wiener_process(x, 0.3, 1.7, d),
          lambda x, d: nt.wiener_process(x, 0.3, 1.7, d), [xi, dt])


@pytest.mark.parametrize("asperity", [None, 0.4])
def test_integrated_wiener_process(asperity):
    rng = np.random.default_rng(9)
    xi, dt, x0 = rng.standard_normal((29, 2)), rng.uniform(0.1, 1.0, 29), rng.standard_normal(2)
    _both(lambda x, d, z: nj.integrated_wiener_process(x, z, 0.8, d, asperity),
          lambda x, d, z: nt.integrated_wiener_process(x, z, torch.tensor(0.8, dtype=torch.float64),
                                                       d, asperity), [xi, dt, x0])


@pytest.mark.parametrize("n", [1, 2, 7, 64, 100])
def test_ornstein_uhlenbeck_process(n):
    rng = np.random.default_rng(10 + n)
    xi, dt = rng.standard_normal(n), rng.uniform(0.1, 1.0, n)
    _both(lambda x, d: nj.ornstein_uhlenbeck_process(x, 0.4, 0.9, 1.3, d),
          lambda x, d: nt.ornstein_uhlenbeck_process(
              x, 0.4, 0.9, torch.tensor(1.3, dtype=torch.float64), d), [xi, dt])


@pytest.mark.parametrize("per_step", [False, True])
def test_discrete_gauss_markov_process(per_step):
    rng = np.random.default_rng(11)
    n, d = 45, 3
    xi, x0 = rng.standard_normal((n, d)), rng.standard_normal(d)
    shape = (n, d, d) if per_step else (d, d)
    drift, amp = 0.3 * rng.standard_normal(shape), rng.standard_normal(shape)
    _both(nj.discrete_gauss_markov_process, nt.discrete_gauss_markov_process, [xi, x0, drift, amp])


def _model_parity(jm, tm, seed):
    assert set(tm.domain) == set(jm.domain)
    rng = np.random.default_rng(seed)
    pos = {k: rng.standard_normal(v.shape) for k, v in jm.domain.items()}
    tan = {k: rng.standard_normal(v.shape) for k, v in jm.domain.items()}
    jp, jt = ({k: jnp.asarray(v) for k, v in t.items()} for t in (pos, tan))
    tp = nt.position_from_numpy(tm, pos, device="cpu", dtype=torch.float64)
    tt = nt.position_from_numpy(tm, tan, device="cpu", dtype=torch.float64)
    jy, jdy = jax.jvp(jm, (jp,), (jt,))
    ty, tdy = torch.func.jvp(tm, (tp,), (tt,))
    for got, want in ((ty, jy), (tdy, jdy)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL * np.abs(want).max())
    assert tuple(tm.target.shape) == tuple(jm.target.shape)


def test_process_models():
    dt = np.random.default_rng(12).uniform(0.2, 1.0, 23)
    _model_parity(nj.WienerProcess((0.5, 0.2), (1.0, 0.3), dt, name="wp"),
                  nt.WienerProcess((0.5, 0.2), (1.0, 0.3), dt, name="wp"), 13)
    _model_parity(nj.WienerProcess(0.0, 1.2, 0.5, name="wp", N_steps=17),
                  nt.WienerProcess(0.0, 1.2, 0.5, name="wp", N_steps=17), 14)
    x0 = (np.array([0.1, -0.2]), np.array([0.5, 0.3]))
    _model_parity(nj.IntegratedWienerProcess(x0, (1.0, 0.3), dt, asperity=(0.2, 0.1)),
                  nt.IntegratedWienerProcess(x0, (1.0, 0.3), dt, asperity=(0.2, 0.1)), 15)
    _model_parity(nj.OrnsteinUhlenbeckProcess((1.0, 0.3), (0.8, 0.2), dt),
                  nt.OrnsteinUhlenbeckProcess((1.0, 0.3), (0.8, 0.2), dt), 16)
    _model_parity(nj.OrnsteinUhlenbeckProcess(0.7, 1.1, 0.4, x0=(0.3, 0.5), N_steps=9),
                  nt.OrnsteinUhlenbeckProcess(0.7, 1.1, 0.4, x0=(0.3, 0.5), N_steps=9), 17)
