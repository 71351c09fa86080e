"""Port parity: samples mapped as one batch (``torch.func.vmap``).

The kernel Functions (K1 ``ModeExpandGrid``, K2 ``ModeCollapseGrid``, K3 +
K4 ``Hartley2d``) have vmap rules that hand the whole batch to one kernel
call (here their plain versions, on the CPU); ``PwlFeatures`` lets vmap
batch its PyTorch ops.  The samplers run their control flow on an explicit
sample axis.  Float64 on the CPU unless a test says otherwise.
Tolerances, and why:

- a vmap rule against a loop of its Function, under ``vmap``,
  ``vmap(jvp)`` and ``vmap(vjp)``: equal for K1 and K2 (gathers and sums
  over the bins, each sample in the same order); the Hartley and the
  relu-feature map 1e-14 of max|ref| (a batched FFT or matrix product
  vectorises over other lanes and may round in another order);
- the KL, its gradient and metric, and both samplers under ``vmap``
  against ``lmap``: relative 1e-12 (the same algorithm; only the batched
  products' and reductions' rounding differs, ~1e-14 of a metric apply,
  and the solves stop after 5-6 CG iterations).  The KL and the linear
  samples hold it elementwise, of max|ref| per leaf; geoVI's samples and
  the VI iteration, after two Newton steps, as the relative L2 norm of
  each sample's whole tree (elementwise, a small leaf such as a scalar
  excitation, summed over the grid, reaches ~1e-11 of its own max);
- the port under ``vmap`` against ``nifty_tpu`` under ``jax.vmap``: the KL
  and its metric 1e-10, the samplers 1e-8 (as ``tests/test_torch_vi.py``
  finds for single samples: CG iterates amplify double rounding);
- float32 on the CPU (the Hartley pair's plain versions): 1e-5 of max|ref|.
"""

import warnings
from functools import partial

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
from nifty_tpu_torch.ops import cuda_fft, pwl
from nifty_tpu_torch.ops import mode_expand as tme
from nifty_tpu_torch.optimize_kl import _kl_met, _kl_vg

torch.set_num_threads(1)


def _close(a, b, rtol):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    np.testing.assert_allclose(a, b, rtol=rtol, atol=rtol * max(np.abs(b).max(), 1e-300))


def _close_tree(got, want, rtol):
    want = want.tree if isinstance(want, nj.Vector) else want
    assert set(got) == set(want)
    for k in want:
        _close(np.asarray(got[k]), np.asarray(want[k]), rtol)


def _close_samples_l2(got, want, rtol):
    """Each sample of two forests within ``rtol`` in the relative L2 norm
    of its whole tree."""
    assert set(got) == set(want)
    for i in range(next(iter(want.values())).shape[0]):
        num = sum(float(((got[k][i] - want[k][i]) ** 2).sum()) for k in want)
        den = sum(float((want[k][i] ** 2).sum()) for k in want)
        assert num <= rtol**2 * den, (i, (num / den) ** 0.5)


@pytest.fixture(autouse=True)
def _no_batching_fallback():
    """A vmap that falls back to a per-sample loop warns ("There is a
    performance drop"); here that is a failure."""
    with warnings.catch_warnings():
        warnings.filterwarnings("error", message=".*performance drop.*")
        yield


# --- the vmap rules --------------------------------------------------------------


def _index(full):
    from nifty_tpu_torch.bench.workload import grid_index

    return grid_index(full)


def _rule_case(kind, B):
    """``(f, inputs, tangents, cotangents, wrapper name)``: one Function of
    one sample and a batch of B inputs for it."""
    rng = np.random.default_rng(B)
    t = lambda *s: torch.from_numpy(rng.standard_normal(s))  # noqa: E731
    if kind in ("expand", "collapse"):
        full = (48, 48)
        index = _index(full)
        U = index.n_unique
        if kind == "expand":
            return (partial(tme.mode_expand_grid, index=index, full_shape=full),
                    t(B, U), t(B, U), t(B, *full), "expand_to_grid")
        f = lambda c: tme.ModeCollapseGrid.apply(c, index, full)  # noqa: E731
        return f, t(B, *full), t(B, *full), t(B, U), "collapse_from_grid"
    if kind == "hartley":
        return cuda_fft.Hartley2d.apply, t(B, 256, 512), t(B, 256, 512), t(B, 256, 512), "hartley_rows"
    x, knots = np.abs(rng.standard_normal((33, 41))) * 3.0, 8
    X, T = torch.from_numpy(x), torch.from_numpy(np.linspace(0.0, x.max(), knots))
    f = lambda c: pwl.PwlFeatures.apply(X, T, c)  # noqa: E731
    return f, t(B, knots - 1), t(B, knots - 1), t(B, 33, 41), None


@pytest.mark.parametrize("transform", ["vmap", "vmap_jvp", "vmap_vjp"])
@pytest.mark.parametrize("B", [1, 2, 4])
@pytest.mark.parametrize("kind", ["expand", "collapse", "hartley", "pwl"])
def test_vmap_rule_matches_a_loop(kind, B, transform, monkeypatch):
    """Each Function under ``vmap``, ``vmap(jvp)`` and ``vmap(vjp)`` equals
    the loop of it over the batch, and the kernel wrapper runs once for
    the whole batch (once a direction), never once a sample."""
    f, x, tan, cot, wrapper = _rule_case(kind, B)
    if transform == "vmap":
        g, args = f, (x,)
        loop = lambda i: f(x[i])  # noqa: E731
    elif transform == "vmap_jvp":
        g = lambda p, v: torch.func.jvp(f, (p,), (v,))[1]  # noqa: E731
        args = (x, tan)
        loop = lambda i: g(x[i], tan[i])  # noqa: E731
    else:
        g = lambda p, c: torch.func.vjp(f, p)[1](c)[0]  # noqa: E731
        args = (x, cot)
        loop = lambda i: g(x[i], cot[i])  # noqa: E731
    calls = []
    if wrapper is not None:
        mod = cuda_fft if kind == "hartley" else tme  # where the Functions look them up
        real = getattr(mod, wrapper)
        monkeypatch.setattr(mod, wrapper, lambda *a: calls.append(1) or real(*a))
    got = torch.func.vmap(g)(*args)
    n_batched = len(calls)
    want = torch.stack([loop(i) for i in range(B)])
    if kind in ("hartley", "pwl"):
        _close(got.numpy(), want.numpy(), 1e-14)
    else:
        np.testing.assert_array_equal(got.numpy(), want.numpy())
    if wrapper is not None:  # the loop calls the wrapper B times for each batched call
        assert n_batched >= 1 and len(calls) - n_batched == B * n_batched


def test_grid_functions_take_a_batch_of_batched_tables():
    """A vmap over tables that already carry K1's trailing sample axis, and
    a vmap nested in another: the mapped axes join that axis."""
    full = (48, 48)
    index = _index(full)
    rng = np.random.default_rng(3)
    tab = torch.from_numpy(rng.standard_normal((2, index.n_unique, 3)))
    got = torch.func.vmap(lambda t: tme.mode_expand_grid(t, index, full))(tab)
    want = torch.stack([tme.mode_expand_grid(t, index, full) for t in tab])
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    tab2 = torch.from_numpy(rng.standard_normal((2, 3, index.n_unique)))
    got = torch.func.vmap(torch.func.vmap(lambda t: tme.mode_expand_grid(t, index, full)))(tab2)
    np.testing.assert_array_equal(got[1, 2].numpy(), tme.mode_expand_grid(tab2[1, 2], index, full).numpy())


def test_batched_hartley_pair_plain_versions():
    """K3 takes a (B, n0, n1) batch as B n0 rows and K4 a batch of half
    spectra: their plain versions equal the slice-by-slice transform."""
    x = torch.from_numpy(np.random.default_rng(4).standard_normal((3, 256, 768)))
    G = cuda_fft.hartley_rows(x)
    assert G.shape == (3, 256, 385)
    H = cuda_fft.hartley_cols(cuda_fft.padded_half_spectrum(G), 768)
    for i in range(3):
        _close(H[i].numpy(), cuda_fft.hartley2d(x[i]).numpy(), 1e-14)


def test_get_map_vmap_and_pmap():
    """``pmap`` without a process group maps on the one rank there is, as
    ``lmap`` (tests/test_torch_parallel.py runs it across ranks)."""
    from nifty_tpu_torch.utils.tree import pmap

    assert nt.get_map("vmap") is nt.vmap and nt.get_map("lmap") is nt.lmap
    assert nt.get_map("pmap") is pmap
    f = lambda a, b: a * b.sum()  # noqa: E731
    a, b = torch.arange(6.0).reshape(3, 2), torch.ones(4)
    np.testing.assert_array_equal(nt.vmap(f, in_axes=(0, None))(a, b).numpy(),
                                  nt.lmap(f, in_axes=(0, None))(a, b).numpy())
    np.testing.assert_array_equal(pmap(f, in_axes=(0, None))(a, b).numpy(),
                                  nt.lmap(f, in_axes=(0, None))(a, b).numpy())
    with pytest.raises(NotImplementedError):
        nt.vmap(f, in_axes=1)


# --- the batched solvers ------------------------------------------------------------


def _spd_batch(B, n=12, seed=0):
    """B SPD dict systems of different conditioning, as a forest."""
    rng = np.random.default_rng(seed)
    mats, rhs = [], []
    for i in range(B):
        Q = rng.standard_normal((n, n))
        mats.append(Q @ Q.T / n + (0.5 + 2.0 * i) * np.eye(n))
        rhs.append(rng.standard_normal(n))
    A = torch.from_numpy(np.stack(mats))
    split = lambda v: {"a": v[..., :4], "b": v[..., 4:].reshape(v.shape[:-1] + (2, 4))}  # noqa: E731
    join = lambda x: torch.cat([x["a"], x["b"].reshape(x["b"].shape[:-2] + (8,))], -1)  # noqa: E731

    def mat_one(M, x):
        return split(M @ join(x))

    b = split(torch.from_numpy(np.stack(rhs)))
    return A, mat_one, b


@pytest.mark.parametrize("kw", [dict(maxiter=30, tol=1e-8), dict(maxiter=25, absdelta=1e-6, miniter=2)])
def test_batched_static_cg_equals_each_sample_alone(kw):
    """Four systems solved as one batch stop at their own iterations, and
    each result is the one its system gets alone: the same iteration count
    and info, the iterate to 1e-10 (up to 30 CG iterations amplify the
    rounding by which the batched products and per-sample sums differ from
    those of one system alone)."""
    A, mat_one, b = _spd_batch(4)
    res = nt.static_cg(lambda x: torch.func.vmap(mat_one)(A, x), b, batched=True, **kw)
    nits = []
    for i in range(4):
        one = nt.static_cg(partial(mat_one, A[i]), {k: v[i] for k, v in b.items()}, **kw)
        assert (int(res.nit[i]), int(res.info[i])) == (int(one.nit), int(one.info))
        _close_tree({k: v[i] for k, v in res.x.items()}, one.x, 1e-10)
        nits.append(int(one.nit))
    assert len(set(nits)) > 1  # the samples stopped at different iterations


def test_batched_static_newton_cg_equals_each_sample_alone():
    """Rosenbrock problems from four starts, one batch: each sample's line
    searches, status and iterate are its own."""
    starts = np.array([[-1.2, 1.0, -0.5, 0.8], [0.5, 0.5, 0.5, 0.5], [2.0, -1.0, 1.5, 0.2], [0.9, 0.8, 0.7, 0.6]])

    def rosen(x):
        return torch.sum(100.0 * (x[1:] - x[:-1] ** 2) ** 2 + (1 - x[:-1]) ** 2)

    vg = nt.optimize.value_and_grad(rosen)
    hessp = lambda x, t: torch.func.jvp(torch.func.grad(rosen), (x,), (t,))[1]  # noqa: E731
    kw = dict(maxiter=6, cg_kwargs=dict(maxiter=20))
    res = nt.static_newton_cg(
        x0=torch.from_numpy(starts), fun_and_grad=torch.func.vmap(vg),
        hessp=torch.func.vmap(hessp), batched=True, **kw)
    for i in range(4):
        one = nt.static_newton_cg(rosen, torch.from_numpy(starts[i]), **kw)
        assert (int(res.nit[i]), int(res.status[i])) == (int(one.nit), int(one.status))
        _close(res.x[i].numpy(), one.x.numpy(), 1e-10)
        _close(float(res.fun[i]), float(one.fun), 1e-10)


def test_batched_line_search_ends_with_the_running_samples():
    """A sample that has stopped does not hold the line search open: sample
    0, a quadratic given the gradient's wrong sign, fails its first search
    (9 trials, status -1); after that each Newton step tries only what the
    Rosenbrock sample 1 needs, as it would alone."""
    x0 = torch.tensor([[0.5, -0.3, 0.2, 0.1], [-1.2, 1.0, -0.5, 0.8]], dtype=torch.float64)

    def rosen(x):
        return torch.sum(100.0 * (x[1:] - x[:-1] ** 2) ** 2 + (1 - x[:-1]) ** 2)

    rosen_vg = nt.optimize.value_and_grad(rosen)
    rosen_hessp = lambda x, t: torch.func.jvp(torch.func.grad(rosen), (x,), (t,))[1]  # noqa: E731
    calls = {"batch": 0, "alone": 0}

    def vg(x):
        calls["batch"] += 1
        e1, g1 = rosen_vg(x[1])
        return torch.stack([(x[0] ** 2).sum(), e1]), torch.stack([-2.0 * x[0], g1])

    def vg_alone(x):
        calls["alone"] += 1
        return rosen_vg(x)

    kw = dict(maxiter=4, xtol=-1.0, cg_kwargs=dict(maxiter=20))
    res = nt.static_newton_cg(
        x0=x0, fun_and_grad=vg, batched=True,
        hessp=lambda x, t: torch.stack([2.0 * t[0], rosen_hessp(x[1], t[1])]), **kw)
    one = nt.static_newton_cg(x0=x0[1], fun_and_grad=vg_alone, hessp=rosen_hessp, **kw)
    assert res.status.tolist() == [-1, int(one.status)] and int(res.nit[0]) == 1
    assert torch.equal(res.x[0], x0[0])
    _close(res.x[1].numpy(), one.x.numpy(), 1e-10)
    # the first step's search runs sample 0's 9 trials, the later ones only sample 1's
    assert calls["batch"] <= 9 + calls["alone"] < 1 + 9 * kw["maxiter"]


# --- the samplers and the KL: vmap against lmap, and against the JAX package ---------


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


def _jax_white(lhj, pj, keys, point_estimates=()):
    """The JAX package's draws inside ``draw_linear_residual(lhj, pj,
    key)`` for each key, stacked as the port's WhiteNoise."""
    lh, p_liquid = lhj.freeze(point_estimates=point_estimates, primals=pj)
    liquid = [k for k in sorted(pj) if k not in point_estimates]
    whites = []
    for key in keys:
        k_nll, k_prr = random.split(key, 2)
        data = np.array(jax_random_like(k_nll, lh.left_sqrt_metric_tangents_shape))
        prior = jax.tree_util.tree_leaves(jax_random_like(k_prr, p_liquid))
        whites.append(nt.WhiteNoise(torch.from_numpy(data),
                                    {k: torch.from_numpy(np.array(v)) for k, v in zip(liquid, prior)}))
    return nt.stack(whites)


KNOTS = [8, None]  # the knot form (PwlFeatures) and the exact form (K1/K2)


@pytest.mark.parametrize("knots", KNOTS)
def test_kl_under_vmap_matches_lmap_and_jax(knots):
    """The sample-averaged KL, its gradient and metric on four samples:
    ``kl_map="vmap"`` against ``"lmap"`` (1e-12) and against the JAX
    package's ``vmap`` (1e-10)."""
    lhj, lht, ct, pos = _poisson_pair(knots=knots, seed=2)
    rng = np.random.default_rng(5)
    res = {k: 0.2 * rng.standard_normal((4,) + v.shape) for k, v in pos.items()}
    tan = {k: rng.standard_normal(v.shape) for k, v in pos.items()}
    at = {k: 0.9 * v for k, v in pos.items()}
    st = nt.samples_from_numpy(ct, pos, res)
    pt, tt = nt.position_from_numpy(ct, at), nt.position_from_numpy(ct, tan)
    vv, gv = _kl_vg(lht, pt, st, map="vmap")
    vl, gl = _kl_vg(lht, pt, st, map="lmap")
    _close(float(vv), float(vl), 1e-12)
    _close_tree(gv, {k: v.numpy() for k, v in gl.items()}, 1e-12)
    mv, ml = _kl_met(lht, pt, tt, st, map="vmap"), _kl_met(lht, pt, tt, st, map="lmap")
    _close_tree(mv, {k: v.numpy() for k, v in ml.items()}, 1e-12)
    sj = nj.Samples(pos=nj.Vector({k: jnp.asarray(v) for k, v in pos.items()}),
                    samples=nj.Vector({k: jnp.asarray(v) for k, v in res.items()}))
    atj = nj.Vector({k: jnp.asarray(v) for k, v in at.items()})
    vj, gj = jax_kl_vg(lhj, atj, sj, map="vmap")
    _close(float(vv), float(vj), 1e-10)
    _close_tree(gv, gj, 1e-10)
    mj = jax_kl_met(lhj, atj, nj.Vector({k: jnp.asarray(v) for k, v in tan.items()}), sj, map="vmap")
    _close_tree(mv, mj, 1e-10)


@pytest.mark.parametrize("point_estimates", [(), ("cfzeromode", "cffluctuations")])
@pytest.mark.parametrize("knots", KNOTS)
def test_draw_linear_residuals_vmap_matches_lmap_and_jax(knots, point_estimates):
    """Four MGVI residuals (6 CG iterations) as one batch, against the loop
    and against ``jax.vmap`` of the JAX package's sampler, from its draws."""
    lhj, lht, ct, pos = _poisson_pair(knots=knots)
    pj, pt = {k: jnp.asarray(v) for k, v in pos.items()}, nt.position_from_numpy(ct, pos)
    keys = random.split(random.PRNGKey(3), 4)
    white = _jax_white(lhj, pj, keys, point_estimates)
    kw = dict(point_estimates=point_estimates, cg_kwargs=dict(maxiter=6, miniter=6, resnorm=-1.0))
    sv, iv = nt.draw_linear_residuals(lht, pt, white=white, residual_map="vmap", **kw)
    sl, il = nt.draw_linear_residuals(lht, pt, white=white, residual_map="lmap", **kw)
    assert iv.tolist() == il.tolist() == [6] * 4
    _close_tree(sv, {k: v.numpy() for k, v in sl.items()}, 1e-12)
    sj, ij = jax.vmap(partial(nj.draw_linear_residual, lhj, pj, **kw))(keys)
    assert np.asarray(ij).tolist() == [6] * 4
    liquid = [k for k in pos if k not in point_estimates]
    _close_tree({k: sv[k] for k in liquid}, {k: sj[k] for k in liquid}, 1e-8)
    assert all(not sv[k].any() and sv[k].shape == (4,) + pt[k].shape for k in point_estimates)


@pytest.mark.parametrize("knots", KNOTS)
def test_nonlinear_update_vmap_matches_lmap_and_jax(knots):
    """geoVI's update of four residuals (Newton-CG 2 steps of CG 5, signs
    ±) as one batch, against the loop and against ``jax.vmap``."""
    lhj, lht, ct, pos = _poisson_pair(knots=knots, seed=1)
    pj, pt = nj.Vector({k: jnp.asarray(v) for k, v in pos.items()}), nt.position_from_numpy(ct, pos)
    keys = random.split(random.PRNGKey(4), 4)
    white = _jax_white(lhj, pj, keys)
    residuals = {k: 0.5 * v for k, v in white.prior.items()}
    signs = [1.0, -1.0, 1.0, -1.0]
    mk = dict(maxiter=2, xtol=-1.0, cg_kwargs=dict(maxiter=5, miniter=5, resnorm=-1.0))
    rv, ov = nt.nonlinearly_update_residuals(lht, pt, residuals, signs=signs, white=white,
                                             residual_map="vmap", minimize_kwargs=mk)
    rl, ol = nt.nonlinearly_update_residuals(lht, pt, residuals, signs=signs, white=white,
                                             residual_map="lmap", minimize_kwargs=mk)
    assert [(int(o.nit), int(o.status)) for o in ov] == [(int(o.nit), int(o.status)) for o in ol] == [(2, 2)] * 4
    _close_samples_l2(rv, rl, 1e-12)
    # the final ½‖r‖², r the small difference of the metric sample and its
    # image: relative rounding grows by (|sample| / |r|)², so 1e-10
    for a, b in zip(ov, ol):
        _close(float(a.fun), float(b.fun), 1e-10)
    rj, oj = jax.vmap(
        partial(nj.nonlinearly_update_residual, lhj, pj, minimize_kwargs=mk),
    )(nj.Vector({k: jnp.asarray(v.numpy()) for k, v in residuals.items()}), keys, jnp.asarray(signs))
    _close_tree(rv, rj, 1e-8)
    _close(np.array([float(o.fun) for o in ov]), np.asarray(oj.fun), 1e-8)


def test_samplers_need_a_batched_solver_under_vmap():
    """The samplers run on a sample axis under every map (a batch of one
    under ``lmap`` and alone), so a solver of one sample is refused."""
    _, lht, ct, pos = _poisson_pair(shape=(16, 16))
    pt = nt.position_from_numpy(ct, pos)
    for residual_map in ("vmap", "lmap"):
        with pytest.raises(TypeError, match="batched form"):
            nt.draw_linear_residuals(lht, pt, [1, 2], cg=nt.cg, residual_map=residual_map)
        with pytest.raises(TypeError, match="batched form"):
            nt.nonlinearly_update_residuals(lht, pt, {k: v[None] for k, v in pt.items()}, [1],
                                            minimize=nt.newton_cg, residual_map=residual_map)
    with pytest.raises(TypeError, match="batched form"):
        nt.draw_linear_residual(lht, pt, 1, cg=nt.cg)


@pytest.mark.parametrize("mode", ["linear_resample", "nonlinear_resample"])
def test_optimize_vi_update_vmap_matches_lmap(mode):
    """One MGVI and one geoVI iteration of ``OptimizeVI.update`` at the
    32² knot-8 model with ``bench_extra.py``'s settings (cut to CG 6):
    the default maps (``vmap``) give the samples, the position and the KL
    of ``lmap`` from the same seed."""
    from nifty_tpu_torch.bench.workload import vi_settings

    _, lht, ct, pos = _poisson_pair(seed=3)
    start = nt.Samples(pos=nt.position_from_numpy(ct, pos))
    fixed = dict(maxiter=6, miniter=6, resnorm=-1.0)
    settings = vi_settings()
    settings["draw_linear_kwargs"]["cg_kwargs"] = fixed
    settings["kl_kwargs"]["minimize_kwargs"]["cg_kwargs"] = fixed
    out = {}
    for maps in ("vmap", "lmap"):
        opt = nt.OptimizeVI(lht, 1, kl_map=maps, residual_map=maps)
        state = opt.init_state(torch.Generator().manual_seed(7), sample_mode=mode, **settings)
        out[maps] = opt.update(start, state)
    (sv, stv), (sl, stl) = out["vmap"], out["lmap"]
    assert sv.keys == sl.keys and len(sv) == 4
    _close_samples_l2(sv._samples, sl._samples, 1e-12)
    _close_samples_l2({k: v[None] for k, v in sv.pos.items()},
                      {k: v[None] for k, v in sl.pos.items()}, 1e-12)
    _close(float(stv.minimization_state.fun), float(stl.minimization_state.fun), 1e-12)
    if mode == "nonlinear_resample":
        assert [int(s.nit) for s in stv.sample_state] == [int(s.nit) for s in stl.sample_state] == [2] * 4


def test_float32_metric_under_vmap_runs_the_kernel_pair_once(monkeypatch):
    """In float32 at 256² the Hartley goes through ``Hartley2d`` (its
    plain versions on the CPU): the KL metric over four samples under
    ``vmap`` runs K3 once per batched transform, not once a sample, and
    agrees with the loop to f32 rounding."""
    ct = _bench_field(nt, (256, 256), 8).to(torch.float32)
    rng = np.random.default_rng(9)
    pos = {k: 0.3 * rng.standard_normal(v.shape) for k, v in ct.domain.items()}
    res = {k: 0.2 * rng.standard_normal((4,) + v.shape) for k, v in pos.items()}
    data = rng.poisson(2.0, size=(256, 256)).astype(np.int32)
    lh = nt.Poissonian(torch.from_numpy(data)).amend(nt.ChainModel(torch.exp, ct))
    st = nt.samples_from_numpy(ct, pos, res)
    tan = nt.position_from_numpy(ct, {k: rng.standard_normal(v.shape) for k, v in pos.items()})
    calls = []
    real = cuda_fft.hartley_rows
    monkeypatch.setattr(cuda_fft, "hartley_rows", lambda x: calls.append(tuple(x.shape)) or real(x))
    mv = _kl_met(lh, st.pos, tan, st, map="vmap")
    # the metric's four transforms (the jvp's primal and tangent, the vjp's
    # primal and cotangent), each once for the four samples
    assert calls == [(4, 256, 256)] * 4
    calls.clear()
    ml = _kl_met(lh, st.pos, tan, st, map="lmap")
    assert calls == [(256, 256)] * 16
    for k in ml:
        _close(mv[k].double().numpy(), ml[k].double().numpy(), 1e-5)
