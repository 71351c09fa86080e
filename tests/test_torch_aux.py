"""Port parity: the inference utilities and the small helpers.

``PyTreeString``/``hide_strings``, ``utils.misc``, the tree helpers
(``dot``, ``ones_like``, ``smap``, ``map_forest``...), the empirical power
spectrum, probing, ``operator_spectrum``, ``adjust_variances``,
``check_model`` and ``profiling``, each against ``nifty_tpu`` on the same
numpy inputs in float64 on the CPU.  Tolerances, and why:

- 1e-10 relative to the largest entry: the same arithmetic in another
  order (FFTs, sums, the interpolant, Hessian-vector products);
- Lanczos eigenvalues 1e-8, ``tests/test_likelihood.py``'s tolerance for
  the JAX package's own (a full Krylov space: the eigenvalues are exact
  up to the reorthogonalisation's rounding);
- ``adjust_variances``: the new θ and ξ 1e-8 (Newton-CG's iterates, as the
  optimizer tests of ``test_torch_vi.py``), φ kept to 1e-10;
- Hutchinson's estimate from the JAX package's own Rademacher probes,
  handed to :func:`nifty_tpu_torch.probing.hutchinson_diagonal`: 1e-10.
"""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from jax import numpy as jnp
from jax import random
from torch.utils import _pytree as pytree

import nifty_tpu as nj
import nifty_tpu_torch as nt
from nifty_tpu import profiling as jax_profiling
from nifty_tpu_torch import profiling
from nifty_tpu_torch.probing import hutchinson_diagonal, rademacher_probes

torch.set_num_threads(1)
RTOL = 1e-10


def _close(got, want, rtol=RTOL):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * max(np.abs(want).max(), 1e-300))


def _close_tree(got, want, rtol=RTOL):
    want = want.tree if isinstance(want, nj.Vector) else want
    assert set(got) == set(want)
    for k in want:
        _close(got[k], want[k], rtol)


# --- the package's namespace ---------------------------------------------------------


def test_public_names_match_the_reference():
    """Every public name of ``nifty_tpu`` is in ``nifty_tpu_torch`` but the
    three that are not ported (``lax``: shims over ``jax.lax``;
    ``blackjax_nuts``: blackjax; ``optax_wrapper``: ``optim_wrapper`` is the
    port's bridge).  Read in a fresh process: a submodule that another
    test imports (``nifty_tpu.parallel``) becomes a name of its package."""
    code = ("import nifty_tpu, nifty_tpu_torch; "
            "pub = lambda m: {n for n in dir(m) if not n.startswith('_')}; "
            "print(sorted(pub(nifty_tpu) - pub(nifty_tpu_torch)))")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300,
                         cwd=root)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().splitlines()[-1] == str(sorted({"lax", "blackjax_nuts", "optax_wrapper"}))


def test_import_loads_neither_matplotlib_nor_h5py():
    """Nor jax, nor the JAX package, with the multi-GPU slice imported too."""
    code = ("import sys, nifty_tpu_torch, nifty_tpu_torch.parallel; "
            "bad = [m for m in ('matplotlib', 'h5py', 'jax', 'nifty_tpu') "
            "if m in sys.modules]; print(bad); sys.exit(1 if bad else 0)")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120,
                         cwd=root)
    assert res.returncode == 0, res.stdout + res.stderr


# --- 1. PyTreeString --------------------------------------------------------------


def test_pytree_string_is_a_node_without_leaves():
    """A PyTreeString flattens to no leaves and comes back from its context;
    ``hide_strings`` wraps every str leaf; the string operations agree with
    the JAX package's."""
    s = nt.PyTreeString("Name")
    leaves, spec = pytree.tree_flatten({"a": s, "b": torch.ones(2)})
    assert len(leaves) == 1 and pytree.tree_unflatten(leaves, spec)["a"] == "Name"
    out = pytree.tree_map(lambda x: 2 * x, {"name": s, "x": torch.ones(2)})
    assert isinstance(out["name"], nt.PyTreeString) and torch.equal(out["x"], 2 * torch.ones(2))
    hidden = nt.hide_strings({"a": "x", "b": [1.0, "y"]})
    assert isinstance(hidden["a"], nt.PyTreeString) and isinstance(hidden["b"][1], nt.PyTreeString)
    assert pytree.tree_leaves(hidden) == [1.0]
    sj = nj.PyTreeString("Name")
    for got, want in ((s + "x", sj + "x"), (s.lower(), sj.lower()), (s.upper(), sj.upper())):
        assert str(got) == str(want) and repr(got) == repr(want)
    assert s == "Name" and s == nt.PyTreeString("Name") and hash(s) == hash(sj)
    assert jax.tree_util.tree_leaves(nj.hide_strings({"a": "x", "b": [1.0, "y"]})) == [1.0]


# --- 2. utils.misc -----------------------------------------------------------------


def test_wrap_and_wrap_left():
    x = {"a": torch.arange(3.0), "b": torch.ones(2)}
    assert torch.equal(nt.wrap(lambda v, c: v * c, "a")(x, 2.0), 2 * x["a"])
    assert nj.wrap(lambda v, c: v * c, "a")({"a": jnp.arange(3.0)}, 2.0).tolist() == [0.0, 2.0, 4.0]
    out = nt.wrap_left(lambda v: v + 1, "c")(x["a"])
    assert set(out) == {"c"} and torch.equal(out["c"], x["a"] + 1)


def test_hvp_matches_jax():
    """The Hessian-vector product of f(x) = Σ sin(x) x³ + (Σx)²."""
    rng = np.random.default_rng(0)
    x, t = rng.standard_normal(7), rng.standard_normal(7)
    want = nj.hvp(lambda v: jnp.sum(jnp.sin(v) * v**3) + jnp.sum(v) ** 2,
                  (jnp.asarray(x),), (jnp.asarray(t),))
    got = nt.hvp(lambda v: torch.sum(torch.sin(v) * v**3) + torch.sum(v) ** 2,
                 (torch.from_numpy(x),), (torch.from_numpy(t),))
    _close(got, want)


def test_hvp_keeps_the_primals_dtypes():
    """Forward over reverse through the float32 correlated-field amplitude
    (its normalisation sums in float64) gives float32 leaves, as
    ``jax.jvp(jax.grad(f))`` does; the same product as float64 tangents
    cast."""
    _, cf, pos = _fields()
    cf = cf.to(torch.float32)
    p = nt.position_from_numpy(cf, pos)
    theta = {k: v for k, v in p.items() if k != cf.xi_key}

    def f(th):
        return torch.log(cf.harmonic_amplitude({**th, cf.xi_key: p[cf.xi_key]})).sum()

    got = nt.hvp(f, (theta,), (theta,))
    raw = torch.func.jvp(torch.func.grad(f), (theta,), (theta,))[1]
    for k in theta:
        assert got[k].dtype == torch.float32
        assert torch.equal(got[k], raw[k].to(torch.float32))


def test_interpolate_matches_jax():
    """The tabulated interpolant of x³ - 2x, inside and outside the table,
    returned in the input's dtype."""

    def f(x):
        return x**3 - 2 * x

    jf = nj.interpolate(-2.0, 3.0, num=41)(f)
    tf = nt.interpolate(-2.0, 3.0, num=41)(f)
    x = np.random.default_rng(1).uniform(-4.0, 5.0, 200)
    _close(tf(torch.from_numpy(x)), jf(jnp.asarray(x)))
    assert tf(torch.zeros(3, dtype=torch.float32)).dtype == torch.float32


def test_conditional_raise_and_call():
    nt.utils.misc.conditional_raise(torch.tensor(False), ValueError("no"))
    with pytest.raises(ValueError, match="yes"):
        nt.utils.misc.conditional_raise(torch.tensor(True), ValueError("yes"))
    seen = []
    nt.utils.misc.conditional_call(torch.tensor(True), seen.append, 1)
    nt.utils.misc.conditional_call(False, seen.append, 2)
    assert seen == [1]


# --- 3. tree helpers -----------------------------------------------------------------


def _tree_pair(seed=0, lead=()):
    rng = np.random.default_rng(seed)
    t = {"a": rng.standard_normal(lead + (3, 4)), "b": rng.standard_normal(lead + (5,))}
    return {k: torch.from_numpy(v) for k, v in t.items()}, {k: jnp.asarray(v) for k, v in t.items()}


def test_dot_ones_like_and_arithmetics_match_jax():
    at, aj = _tree_pair(0)
    bt, bj = _tree_pair(1)
    _close(nt.dot(at, bt), nj.dot(aj, bj))
    c = torch.tensor([1 + 2j, 3 - 1j])
    _close(nt.dot({"c": c}, {"c": c}), nj.dot({"c": jnp.asarray(c.numpy())}, {"c": jnp.asarray(c.numpy())}))
    _close_tree(nt.ones_like(at), nj.ones_like(aj))
    full = nt.utils.tree.full_like({"s": nt.ShapeWithDtype((2, 3), torch.float32), "t": at["b"]}, 7.0,
                                   device="cpu")
    assert full["s"].dtype == torch.float32 and torch.equal(full["s"], torch.full((2, 3), 7.0))
    assert torch.equal(full["t"], torch.full((5,), 7.0, dtype=torch.float64))
    for tree, ok in (({"a": torch.ones(2), "b": 1.0, "c": np.ones(2)}, True), ({"a": "x"}, False)):
        assert nt.utils.tree.has_arithmetics(tree) is ok
    nt.assert_arithmetics({"a": torch.ones(2), "b": 3})
    with pytest.raises(TypeError, match="non-arithmetic"):
        nt.assert_arithmetics({"a": torch.ones(2), "b": object()})
    with pytest.raises(TypeError):
        nj.assert_arithmetics({"a": jnp.ones(2), "b": object()})


@pytest.mark.parametrize("map_name", ["vmap", "lmap", "smap"])
def test_map_forest_and_smap_match_jax(map_name):
    """``map_forest`` / ``map_forest_mean`` of a function of one sample and a
    shared argument, and ``smap`` as a name for the host loop."""
    ft, fj = _tree_pair(2, lead=(4,))
    ct, cj = _tree_pair(3)

    def fun(lib):
        return lambda x, c: {"s": lib.sum(x["a"] * c["a"]) + x["b"][0], "v": x["b"] * c["b"]}

    got = nt.map_forest(fun(torch), map=map_name, in_axes=(0, None))(ft, ct)
    want = nj.map_forest(fun(jnp), map=map_name if map_name != "lmap" else "lmap",
                         in_axes=(0, None))(fj, cj)
    _close_tree(got, want)
    _close_tree(nt.map_forest_mean(fun(torch), map=map_name, in_axes=(0, None))(ft, ct),
                nj.map_forest_mean(fun(jnp), map=map_name, in_axes=(0, None))(fj, cj))
    assert nt.smap is nt.lmap and nt.get_map("smap") is nt.lmap


# --- 4. the empirical power spectrum ----------------------------------------------------


@pytest.mark.parametrize("case", ["2d", "window_axis", "one_axis_int"])
def test_empirical_power_spectrum_matches_jax(case):
    """Binned |FFT|² against the JAX package's: a 2-D field with unequal
    distances, a Hann window over the last two axes of a 3-D field (the
    first survives), and one axis given as an int; twice the same bits."""
    rng = np.random.default_rng(3)
    if case == "2d":
        x, kw = rng.standard_normal((40, 24)), dict(distances=(0.5, 0.25), n_bins=16)
    elif case == "window_axis":
        x, kw = rng.standard_normal((3, 20, 16)), dict(distances=0.1, axes=(1, 2), use_window=True,
                                                      n_bins=12)
    else:
        x, kw = rng.standard_normal((6, 50)), dict(distances=0.02, axes=-1, n_bins=10)
    psj, kj = nj.compute_empirical_power_spectrum(jnp.asarray(x), **kw)
    ps, k = nt.compute_empirical_power_spectrum(torch.from_numpy(x), **kw)
    _close(ps, psj)
    _close(k, kj)
    assert torch.equal(ps, nt.compute_empirical_power_spectrum(torch.from_numpy(x), **kw)[0])
    ps_np, _ = nt.compute_empirical_power_spectrum(x, device="cpu", **kw)  # numpy in
    assert torch.equal(ps_np, ps)


def test_empirical_power_spectrum_recovers_powerlaw():
    """``tests/test_aux.py``'s check on a correlated field of the port: a
    steep red spectrum falls by orders of magnitude over k."""
    cfm = nt.CorrelatedFieldMaker("cf")
    cfm.set_amplitude_total_offset(0.0, (1e-1, 3e-2))
    cfm.add_fluctuations((128,), 1.0 / 128, (1.0, 0.1), (-4.0, 0.1))
    cf = cfm.finalize(device="cpu", dtype=torch.float64)
    rng = np.random.default_rng(0)
    pos = nt.position_from_numpy(cf, {k: rng.standard_normal(v.shape) for k, v in cf.domain.items()})
    with torch.no_grad():
        ps, _ = nt.compute_empirical_power_spectrum(cf(pos), distances=1.0 / 128, n_bins=12)
    assert ps[0] > ps[-1] * 10


# --- 5. probing -------------------------------------------------------------------------


def _spd(n, seed):
    a = np.random.default_rng(seed).standard_normal((n, n))
    return a @ a.T + np.eye(n)


def _dict_op(m, lib, as_tensor):
    """The matrix ``m`` acting on the dict {"a": (4,), "b": (2, 4)} raveled
    in sorted key order."""
    M = as_tensor(m)

    def op(x):
        flat = lib.concatenate([x["a"].reshape(-1), x["b"].reshape(-1)]) if lib is jnp else \
            torch.cat([x["a"].reshape(-1), x["b"].reshape(-1)])
        y = M @ flat
        return {"a": y[:4], "b": y[4:].reshape(2, 4)}

    return op


def test_probe_diagonal_exact_matches_jax():
    m = _spd(12, 15)
    proto_t = {"a": torch.zeros(4, dtype=torch.float64), "b": torch.zeros(2, 4, dtype=torch.float64)}
    proto_j = {"a": jnp.zeros(4), "b": jnp.zeros((2, 4))}
    got = nt.probe_diagonal(_dict_op(m, torch, torch.from_numpy), proto_t)
    want = nj.probe_diagonal(_dict_op(m, jnp, jnp.asarray), proto_j)
    _close_tree(got, want)
    _close(torch.cat([got["a"], got["b"].reshape(-1)]), np.diag(m))


def test_hutchinson_from_the_reference_probes_matches_jax():
    """The JAX package's 40 Rademacher probes (its key schedule, every leaf
    from ``fold_in(sk, 0)``) through the port's estimator."""
    m = _spd(12, 16)
    proto_j = {"a": jnp.zeros(4), "b": jnp.zeros((2, 4))}
    key, probes = random.PRNGKey(16), []
    for _ in range(40):
        key, sk = random.split(key)
        probes.append({k: torch.from_numpy(np.array(random.rademacher(
            random.fold_in(sk, 0), v.shape, dtype=v.dtype))) for k, v in proto_j.items()})
    want = nj.probe_diagonal(_dict_op(m, jnp, jnp.asarray), proto_j, random.PRNGKey(16), n_probes=40)
    got = hutchinson_diagonal(_dict_op(m, torch, torch.from_numpy), probes)
    _close_tree(got, want)


def test_probe_diagonal_stochastic():
    """Seeded probes replay; the leaves draw from one stream (the JAX
    package draws every leaf from one key, so same-shaped leaves get the
    same probe there); the estimate is within 3 max|M|/√n of the diagonal."""
    m = _spd(12, 17)
    proto = {"a": torch.zeros(4, dtype=torch.float64), "b": torch.zeros(2, 4, dtype=torch.float64)}
    op = _dict_op(m, torch, torch.from_numpy)
    d1 = nt.probe_diagonal(op, proto, 5, n_probes=300)
    d2 = nt.probe_diagonal(op, proto, torch.Generator().manual_seed(5), n_probes=300)
    _close_tree(d1, {k: v.numpy() for k, v in d2.items()}, rtol=0.0)
    est = torch.cat([d1["a"], d1["b"].reshape(-1)]).numpy()
    np.testing.assert_allclose(est, np.diag(m), atol=3 * np.abs(m).max() / np.sqrt(300))
    (p,) = rademacher_probes({"x": torch.zeros(6), "y": torch.zeros(6)}, 0, 1)
    assert set(p["x"].unique().tolist()) <= {-1.0, 1.0} and not torch.equal(p["x"], p["y"])
    with pytest.raises(ValueError, match="key"):
        nt.probe_diagonal(op, proto, n_probes=3)


def test_stat_calculator_and_posterior_probe_match_jax():
    data = np.random.default_rng(1).normal(size=(50, 4))
    st, sj = nt.StatCalculator(), nj.StatCalculator()
    for row in data:
        st.add({"x": torch.from_numpy(row)})
        sj.add({"x": jnp.asarray(row)})
    _close_tree(st.mean, sj.mean)
    _close_tree(st.var, sj.var)
    _close(st.var["x"], data.var(0, ddof=1))
    with pytest.raises(RuntimeError):
        nt.StatCalculator().mean
    seeds = []

    def draw(seed):
        seeds.append(seed)
        return torch.from_numpy(np.random.default_rng(seed).standard_normal(3))

    mean, var = nt.probe_with_posterior_samples(draw, lambda s: s**2, 5, 7)
    want = np.stack([np.random.default_rng(s).standard_normal(3) ** 2 for s in seeds])
    _close(mean, want.mean(0))
    _close(var, want.var(0, ddof=1))
    assert nt.probe_with_posterior_samples(draw, None, 1, 7)[1] is None


# --- 6. operator_spectrum -----------------------------------------------------------------


def test_operator_spectrum_hermitian_matches_jax():
    """``tests/test_likelihood.py``'s check, on a dict domain: 5 leading
    eigenvalues of a 12-dof SPD map, in both packages and by numpy."""
    m = _spd(12, 0)
    proto_t = {"a": torch.zeros(4, dtype=torch.float64), "b": torch.zeros(2, 4, dtype=torch.float64)}
    proto_j = {"a": jnp.zeros(4), "b": jnp.zeros((2, 4))}
    got = nt.operator_spectrum(_dict_op(m, torch, torch.from_numpy), proto_t, 5)
    want = nj.operator_spectrum(_dict_op(m, jnp, jnp.asarray), proto_j, 5, verbose=False)
    expect = np.sort(np.linalg.eigvalsh(m))[::-1][:5]
    np.testing.assert_allclose(got, want, rtol=1e-8)
    np.testing.assert_allclose(got, expect, rtol=1e-8)
    again = nt.operator_spectrum(_dict_op(m, torch, torch.from_numpy), proto_t, 5, key=3, n_batches=2)
    np.testing.assert_allclose(again, expect, rtol=1e-8)


def test_operator_spectrum_dense_matches_jax():
    b = np.random.default_rng(1).normal(size=(10, 10))
    got = nt.operator_spectrum(lambda x: torch.from_numpy(b) @ x, torch.zeros(10, dtype=torch.float64),
                               10, hermitian=False)
    want = nj.operator_spectrum(lambda x: jnp.asarray(b) @ x, jnp.zeros(10), 10, hermitian=False)
    np.testing.assert_allclose(got, want, rtol=1e-8)
    with pytest.raises(ValueError, match="dense_cutoff"):
        nt.operator_spectrum(lambda x: x, torch.zeros(10, dtype=torch.float64), 2, hermitian=False,
                             dense_cutoff=8)


# --- 7. adjust_variances --------------------------------------------------------------------


def test_adjust_variances_matches_jax():
    """``tests/test_aux.py``'s set-up: an overscaled ξ (std 5) and a scalar
    log-amplitude; the scale moves into the amplitude, φ stays."""
    n = 64
    xi = 5.0 * np.random.default_rng(0).normal(size=n)
    pj = {"loga": jnp.asarray(0.0), "xi": jnp.asarray(xi)}
    pt = {"loga": torch.tensor(0.0, dtype=torch.float64), "xi": torch.from_numpy(xi)}
    new_j = nj.adjust_variances(pj, lambda p: jnp.exp(p["loga"]) * jnp.ones(n), "xi")
    new_t = nt.adjust_variances(pt, lambda p: torch.exp(p["loga"]) * torch.ones(n, dtype=torch.float64),
                                "xi")
    _close_tree(new_t, new_j, rtol=1e-8)
    _close(torch.exp(new_t["loga"]) * new_t["xi"], np.exp(0.0) * xi)
    assert float(new_t["loga"]) > 0.5 and abs(float(new_t["xi"].std()) - 1) < abs(xi.std() - 1)


# --- 8-9. check_model and profiling ------------------------------------------------------------


def _fields(shape=(32,)):
    cfmj, cfmt = nj.CorrelatedFieldMaker("cf"), nt.CorrelatedFieldMaker("cf")
    for cfm in (cfmj, cfmt):
        cfm.set_amplitude_total_offset(0.0, (1e-1, 3e-2))
        cfm.add_fluctuations(shape, 1.0 / shape[0], (1.0, 0.5), (-3.0, 0.2))
    cft = cfmt.finalize(device="cpu", dtype=torch.float64)
    rng = np.random.default_rng(0)
    pos = {k: rng.standard_normal(v.shape) for k, v in sorted(cft.domain.items())}
    return cfmj.finalize(), cft, pos


def test_check_model_reports_the_reference_modes(monkeypatch):
    """The report's modes are the JAX package's (its timing loop cut to one
    call); on the CPU each has a positive eager time and no device numbers;
    the listing names the model's buffers."""
    monkeypatch.setattr(sys.modules["nifty_tpu.check_model"], "_benchmark",
                        lambda func, *args: (jax.block_until_ready(func(*args)), 1e-3)[1])
    cfj, cft, pos = _fields()
    msgs = []
    report = nt.check_model(cft, nt.position_from_numpy(cft, pos), log=msgs.append)
    want = nj.check_model(cfj, {k: jnp.asarray(v) for k, v in pos.items()}, log=lambda m: None)
    assert set(report) == set(want) == {"forward", "jvp", "vjp"}
    for mode in report.values():
        assert mode["time_raw"] > 0 and mode["device_ms"] is None and mode["peak_bytes"] is None
    assert any("=== forward ===" in m for m in msgs)
    names = [name for name, _ in cft.named_buffers()]
    assert names and all(name in msgs[-1] for name in names)


def test_exec_time_and_counting_call_match_jax():
    """``exec_time``'s keys, and ``CountingCall``'s counts of plain calls
    and calls under forward-mode AD, as the JAX package counts them."""
    cfj, cft, pos = _fields()
    pt = nt.position_from_numpy(cft, pos)
    res = profiling.exec_time(cft, pt, n=2, verbose=False)
    assert set(res) == {"compile", "forward", "jvp", "vjp"} and all(v > 0 for v in res.values())
    ct, cj = profiling.CountingCall(torch.sin, "sin"), jax_profiling.CountingCall(jnp.sin, "sin")
    x = np.linspace(0.0, 1.0, 5)
    for c, lib, X in ((ct, torch.func, torch.from_numpy(x)), (cj, jax, jnp.asarray(x))):
        c(X)
        lib.jvp(c, (X,), (X,))
        lib.vjp(c, X)[1](X)
        lib.grad(lambda v, c=c: c(v).sum())(X)
    assert (ct.n_apply, ct.n_jvp, ct.n_vjp) == (cj.n_apply, cj.n_jvp, cj.n_vjp) == (3, 1, 0)
    assert ct.report() == cj.report()
    ct.reset()
    assert ct.n_apply == ct.n_jvp == 0
