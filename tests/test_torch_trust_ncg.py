"""Port parity: the Steihaug CG and the trust-region Newton-CG.

The cases of ``tests/test_solvers.py`` (the Steihaug subproblem inside,
on and across the trust radius; trust-NCG on Rosenbrock and a quadratic)
go through both packages with the same numpy inputs, in float64 on the
CPU, and the KL step of the VI loop takes ``trust_ncg`` as its minimiser.
Tolerances, and why: the subproblem's step, model value and flags 1e-10
relative (the same recurrence; summation orders differ); trust-NCG's
iterates 1e-8 (each outer step is such a solve, and a few steps compound
its rounding); where the JAX test holds the result against an analytic
answer, the port is held to the same bound.
"""

import numpy as np
import pytest
import torch
from jax import numpy as jnp

import nifty_tpu as nj
import nifty_tpu_torch as nt
from nifty_tpu.conjugate_gradient import cg_steihaug as jax_cg_steihaug
from nifty_tpu.optimize_kl import _kl_met as jax_kl_met
from nifty_tpu.optimize_kl import _kl_vg as jax_kl_vg

torch.set_num_threads(1)


def _close(a, b, rtol):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    np.testing.assert_allclose(a, b, rtol=rtol, atol=rtol * max(np.abs(b).max(), 1e-300))


def _spd(seed, n=6):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(n, n))
    return A @ A.T + n * np.eye(n), rng.normal(size=n)


STEIHAUG_CASES = {
    "interior": dict(seed=0, radius=1e3, kw=dict(resnorm=1e-12)),
    "boundary": dict(seed=1, radius=0.05, kw=dict(resnorm=1e-12)),
    "absdelta": dict(seed=2, radius=1e3, kw=dict(absdelta=1e-3, miniter=2)),
    "negative_curvature": dict(seed=None, radius=2.0, kw={}),
}


@pytest.mark.parametrize("case", sorted(STEIHAUG_CASES))
def test_cg_steihaug_matches_jax(case):
    """Step, crossing flag, predicted model value and iteration count of
    both packages' Steihaug CG (``tests/test_solvers.py:123-158``)."""
    c = STEIHAUG_CASES[case]
    if c["seed"] is None:  # an indefinite matrix walks to the boundary
        A, b = -np.eye(3), np.array([1.0, 0.0, 0.0])
    else:
        A, b = _spd(c["seed"])
    rj = jax_cg_steihaug(lambda x: jnp.asarray(A) @ x, jnp.asarray(b), trust_radius=c["radius"],
                         cur_val=1.5, **c["kw"])
    At = torch.from_numpy(A)
    rt = nt.cg_steihaug(lambda x: At @ x, torch.from_numpy(b), trust_radius=c["radius"],
                        cur_val=1.5, **c["kw"])
    assert bool(rt.hits_boundary) == bool(rj.hits_boundary)
    assert (int(rt.nit), int(rt.nhev)) == (int(rj.nit), int(rj.nhev))
    _close(rt.step.numpy(), rj.step, 1e-10)
    _close(float(rt.pred_f), float(rj.pred_f), 1e-10)
    if case == "interior":
        _close(rt.step.numpy(), -np.linalg.solve(A, b), 1e-10)
    elif case == "boundary":
        assert bool(rt.hits_boundary)
        _close(float(torch.linalg.vector_norm(rt.step)), 0.05, 1e-10)
    elif case == "negative_curvature":
        assert bool(rt.hits_boundary)
        _close(float(torch.linalg.vector_norm(rt.step)), 2.0, 1e-12)
        _close(float(rt.pred_f) - 1.5, -4.0, 1e-12)  # ⟨g, p⟩ + ½⟨p, B p⟩


def _rosen(x, lib):
    return lib.sum(100.0 * (x[1:] - x[:-1] ** 2) ** 2 + (1 - x[:-1]) ** 2)


@pytest.mark.parametrize("maxiter", [1, 4, 500])
def test_trust_ncg_rosenbrock_matches_jax(maxiter):
    """``minimize(method="trust-ncg")`` on Rosenbrock from zero: after 1
    and 4 steps and converged (``tests/test_solvers.py:165-171``)."""
    opts = dict(maxiter=maxiter, gtol=1e-8)
    rj = nj.minimize(lambda x: _rosen(x, jnp), jnp.zeros(6), method="trust-ncg", options=opts)
    rt = nt.minimize(lambda x: _rosen(x, torch), torch.zeros(6, dtype=torch.float64),
                     method="trust-ncg", options=opts)
    assert (int(rt.nit), int(rt.status), int(rt.nhev)) == (int(rj.nit), int(rj.status), int(rj.nhev))
    _close(rt.x.numpy(), rj.x, 1e-8)
    if maxiter == 500:
        assert int(rt.status) == 0
        np.testing.assert_allclose(rt.x.numpy(), 1.0, atol=1e-6)


def test_trust_ncg_quadratic_matches_jax():
    """A dict quadratic with its Hessian as ``hessp`` and the ``tol`` of
    ``minimize`` as ``gtol`` (``tests/test_solvers.py:174-190``)."""
    A, b = _spd(0, n=8)
    x0 = {"a": np.zeros(3), "b": np.zeros(5)}

    def fun(x, lib, As, bs):
        v = lib.cat([x["a"], x["b"]]) if lib is torch else lib.concatenate([x["a"], x["b"]])
        return 0.5 * v @ As @ v - bs @ v

    Aj, bj = jnp.asarray(A), jnp.asarray(b)
    At, bt = torch.from_numpy(A), torch.from_numpy(b)
    rj = nj.minimize(lambda x: fun(x, jnp, Aj, bj), {k: jnp.asarray(v) for k, v in x0.items()},
                     method="trust-ncg", tol=1e-10, options=dict(maxiter=100))
    rt = nt.minimize(lambda x: fun(x, torch, At, bt), {k: torch.from_numpy(v) for k, v in x0.items()},
                     method="trust-ncg", tol=1e-10, options=dict(maxiter=100))
    assert (int(rt.nit), int(rt.status)) == (int(rj.nit), int(rj.status))
    sol = np.linalg.solve(A, b)
    for k, sl in (("a", slice(0, 3)), ("b", slice(3, 8))):
        _close(rt.x[k].numpy(), rj.x[k], 1e-8)
        np.testing.assert_allclose(rt.x[k].numpy(), sol[sl], atol=1e-8)


def test_trust_ncg_rejects_bad_parameters():
    f = lambda x: (x**2).sum()  # noqa: E731
    x0 = torch.zeros(2, dtype=torch.float64)
    for kw in (dict(eta=0.3), dict(gtol=-1.0), dict(initial_trust_radius=2000.0)):
        with pytest.raises(ValueError):
            nt.trust_ncg(f, x0, **kw)


def _bench_field(pkg, shape, knots):
    cfm = pkg.CorrelatedFieldMaker("cf")
    cfm.set_amplitude_total_offset(offset_mean=1.0, offset_std=(1e-1, 3e-2))
    cfm.add_fluctuations(shape, distances=1.0 / shape[0], fluctuations=(1.0, 5e-1),
                         loglogavgslope=(-3.0, 2e-1), flexibility=(1e0, 2e-1), n_mode_knots=knots)
    return cfm.finalize() if pkg is nj else cfm.finalize(device="cpu", dtype=torch.float64)


def _poisson_pair(shape=(32, 32), knots=8, seed=0):
    cj, ct = _bench_field(nj, shape, knots), _bench_field(nt, shape, knots)
    rng = np.random.default_rng(seed)
    pos = {k: 0.3 * rng.standard_normal(v.shape) for k, v in sorted(ct.domain.items())}
    data = rng.poisson(2.0, size=shape).astype(np.int32)
    lhj = nj.Poissonian(jnp.asarray(data)).amend(nj.ChainModel(jnp.exp, cj))
    lht = nt.Poissonian(torch.from_numpy(data)).amend(nt.ChainModel(torch.exp, ct))
    return lhj, lht, ct, pos


def test_kl_step_by_trust_ncg_matches_jax():
    """``kl_kwargs=dict(minimize=trust_ncg, ...)``: the VI loop's KL step by
    trust-NCG (3 steps, Steihaug CG 6) on the 32² knot-8 Poisson model and
    four samples, against the JAX package's ``trust_ncg`` on its KL."""
    lhj, lht, ct, pos = _poisson_pair(seed=4)
    rng = np.random.default_rng(6)
    res = {k: 0.2 * rng.standard_normal((4,) + v.shape) for k, v in pos.items()}
    mk = dict(maxiter=3, subproblem_kwargs=dict(maxiter=6, miniter=6))
    st = nt.samples_from_numpy(ct, pos, res)
    opt = nt.OptimizeVI(lht, 1)
    rt = opt.kl_minimize(st, minimize=nt.trust_ncg, minimize_kwargs=mk)
    sj = nj.Samples(pos=nj.Vector({k: jnp.asarray(v) for k, v in pos.items()}),
                    samples=nj.Vector({k: jnp.asarray(v) for k, v in res.items()}))
    rj = nj.trust_ncg(
        None, x0=sj.pos,
        fun_and_grad=lambda x: jax_kl_vg(lhj, x, sj),
        hessp=lambda x, t: jax_kl_met(lhj, x, t, sj), **mk,
    )
    assert (int(rt.nit), int(rt.status)) == (int(rj.nit), int(rj.status))
    _close(float(rt.fun), float(rj.fun), 1e-8)
    for k in pos:
        _close(rt.x[k].numpy(), rj.x.tree[k], 1e-8)
    assert float(rt.fun) < float(_kl_value(opt, st))


def _kl_value(opt, samples):
    return opt.kl_value_and_grad(samples.pos, primals_samples=samples)[0]


def test_optimize_kl_takes_trust_ncg():
    """``optimize_kl`` with ``kl_kwargs=dict(minimize=trust_ncg)`` (and the
    default maps, vmap): the KL falls over the iteration."""
    _, lh, ct, pos = _poisson_pair(shape=(16, 16), seed=5)
    start = nt.position_from_numpy(ct, pos)
    samples, state = nt.optimize_kl(
        lh, start, key=torch.Generator().manual_seed(2), n_total_iterations=1, n_samples=1,
        draw_linear_kwargs=dict(cg_kwargs=dict(maxiter=10)), sample_mode="linear_resample",
        kl_kwargs=dict(minimize=nt.trust_ncg,
                       minimize_kwargs=dict(maxiter=3, subproblem_kwargs=dict(maxiter=10))),
    )
    before = nt.OptimizeVI(lh, 1).kl_value_and_grad(start, primals_samples=samples.at(start))[0]
    assert int(state.minimization_state.nit) >= 1
    assert float(state.minimization_state.fun) < float(before)
