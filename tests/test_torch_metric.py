"""Port parity: the Poisson Fisher metric of the exact correlated field and
the CG solve over it — the slice as a whole.

Both packages build ``Poissonian(data).amend(ChainModel(exp, cf))`` and
get the same numpy-made position, tangent and data.  Float64 on the CPU,
rtol 1e-10 of max|ref| per leaf (exact algorithms in double precision).
"""

import jax
import numpy as np
import pytest
import torch
from jax import numpy as jnp

import nifty_tpu as nj
import nifty_tpu_torch as nt

torch.set_num_threads(1)
RTOL = 1e-10


def _close(a, b, rtol=RTOL):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    np.testing.assert_allclose(a, b, rtol=rtol, atol=rtol * max(np.abs(b).max(), 1e-300))


def _close_tree(got, want, rtol=RTOL):
    want = want.tree if isinstance(want, nj.Vector) else want
    assert set(got) == set(want)
    for k in want:
        _close(got[k].numpy(), want[k], rtol)


def _cf(pkg, shape):
    cfm = pkg.CorrelatedFieldMaker("cf")
    cfm.set_amplitude_total_offset(offset_mean=1.0, offset_std=(1e-1, 3e-2))
    cfm.add_fluctuations(
        shape,
        distances=1.0 / shape[0],
        fluctuations=(1.0, 5e-1),
        loglogavgslope=(-3.0, 2e-1),
        flexibility=(1e0, 2e-1),
    )
    return cfm.finalize() if pkg is nj else cfm.finalize(device="cpu", dtype=torch.float64)


def _setup(shape, seed=0):
    cj, ct = _cf(nj, shape), _cf(nt, shape)
    rng = np.random.default_rng(seed)
    pos = {k: 0.5 * rng.standard_normal(v.shape) for k, v in ct.domain.items()}
    tan = {k: rng.standard_normal(v.shape) for k, v in ct.domain.items()}
    data = rng.poisson(1.0, size=shape).astype(np.int32)
    lhj = nj.Poissonian(jnp.asarray(data)).amend(nj.ChainModel(jnp.exp, cj))
    lht = nt.Poissonian(torch.from_numpy(data)).amend(nt.ChainModel(torch.exp, ct))
    vj = lambda t: nj.Vector({k: jnp.asarray(v) for k, v in t.items()})
    vt = lambda t: nt.position_from_numpy(ct, t, dtype=torch.float64)
    return lhj, lht, vj, vt, pos, tan, data


@pytest.mark.parametrize("shape", [(48, 48), (48, 64)])
def test_poisson_metric(shape):
    lhj, lht, vj, vt, pos, tan, _ = _setup(shape)
    _close_tree(lht.metric(vt(pos), vt(tan)), lhj.metric(vj(pos), vj(tan)))


@pytest.mark.parametrize("shape", [(48, 48), (48, 64)])
def test_poisson_left_sqrt_metric(shape):
    lhj, lht, vj, vt, pos, _, _ = _setup(shape, seed=1)
    d = np.random.default_rng(2).standard_normal(shape)
    _close_tree(lht.left_sqrt_metric(vt(pos), torch.from_numpy(d)),
                lhj.left_sqrt_metric(vj(pos), jnp.asarray(d)))


@pytest.mark.parametrize("shape", [(48, 48), (48, 64)])
def test_poisson_right_sqrt_metric(shape):
    lhj, lht, vj, vt, pos, tan, _ = _setup(shape, seed=3)
    got = lht.right_sqrt_metric(vt(pos), vt(tan))
    _close(got.numpy(), lhj.right_sqrt_metric(vj(pos), vj(tan)))


def test_metric_is_lsm_of_rsm():
    _, lht, _, vt, pos, tan, _ = _setup((32, 32), seed=4)
    p, t = vt(pos), vt(tan)
    via_sqrt = lht.left_sqrt_metric(p, lht.right_sqrt_metric(p, t))
    direct = lht.metric(p, t)
    for k in direct:
        _close(direct[k].numpy(), via_sqrt[k].numpy())


def test_energy_and_residual():
    lhj, lht, vj, vt, pos, _, _ = _setup((48, 64), seed=5)
    _close(lht.energy(vt(pos)).numpy(), lhj.energy(vj(pos)))
    _close(lht.normalized_residual(vt(pos)).numpy(), lhj.normalized_residual(vj(pos)))


def test_poisson_refuses_float_data():
    with pytest.raises(TypeError):
        nt.Poissonian(torch.zeros(4))


@pytest.mark.parametrize("noise", ["std_array", "cov_callable", "white"])
def test_gaussian_metric(noise):
    shape = (32, 40)
    cj, ct = _cf(nj, shape), _cf(nt, shape)
    rng = np.random.default_rng(6)
    pos = {k: rng.standard_normal(v.shape) for k, v in ct.domain.items()}
    tan = {k: rng.standard_normal(v.shape) for k, v in ct.domain.items()}
    data = rng.standard_normal(shape)
    w = rng.uniform(0.5, 2.0, shape)
    kw_j = {"std_array": dict(noise_std_inv=jnp.asarray(w)),
            "cov_callable": dict(noise_cov_inv=lambda x: 3.0 * x), "white": {}}[noise]
    kw_t = {"std_array": dict(noise_std_inv=torch.from_numpy(w)),
            "cov_callable": dict(noise_cov_inv=lambda x: 3.0 * x), "white": {}}[noise]
    lhj = nj.Gaussian(jnp.asarray(data), **kw_j).amend(cj)
    lht = nt.Gaussian(torch.from_numpy(data), **kw_t).amend(ct)
    pj = nj.Vector({k: jnp.asarray(v) for k, v in pos.items()})
    tj = nj.Vector({k: jnp.asarray(v) for k, v in tan.items()})
    pt, tt = nt.position_from_numpy(ct, pos), nt.position_from_numpy(ct, tan)
    _close_tree(lht.metric(pt, tt), lhj.metric(pj, tj))
    _close(lht.energy(pt).numpy(), lhj.energy(pj))
    _close(lht.right_sqrt_metric(pt, tt).numpy(), lhj.right_sqrt_metric(pj, tj))


def test_cg_iterates_match_jax():
    """10 CG iterations on (M + 1) x = b, the inner solve of an MGVI sample
    draw: the same iterates in both packages."""
    lhj, lht, vj, vt, pos, tan, _ = _setup((32, 32), seed=7)
    pj, pt = vj(pos), vt(pos)

    def mat_j(x):
        return lhj.metric(pj, x) + x

    def mat_t(x):
        m = lht.metric(pt, x)
        return {k: m[k] + x[k] for k in x}

    kw = dict(maxiter=10, miniter=10, absdelta=0.0)
    rj = nj.cg(mat_j, vj(tan), **kw)
    rt = nt.cg(mat_t, vt(tan), **kw)
    assert rt.nit == int(rj.nit) == 10
    _close_tree(rt.x, rj.x, 1e-9)
    res0 = float(nt.norm(vt(tan)))
    mx = mat_t(rt.x)
    res = float(nt.norm({k: mx[k] - vt(tan)[k] for k in mx}))
    assert res < 0.5 * res0


def test_cg_solves_spd_system():
    rng = np.random.default_rng(8)
    A = rng.standard_normal((20, 20))
    A = A @ A.T + 20 * np.eye(20)
    b = rng.standard_normal(20)
    At = torch.from_numpy(A)
    res = nt.cg(lambda x: {"v": At @ x["v"]}, {"v": torch.from_numpy(b)}, tol=1e-12, maxiter=200)
    assert res.success
    _close(res.x["v"].numpy(), np.linalg.solve(A, b), 1e-8)


def test_tree_algebra():
    rng = np.random.default_rng(9)
    a = {"x": torch.from_numpy(rng.standard_normal(5)), "y": torch.from_numpy(rng.standard_normal((2, 3)))}
    b = {"x": torch.from_numpy(rng.standard_normal(5)), "y": torch.from_numpy(rng.standard_normal((2, 3)))}
    flat = lambda t: np.concatenate([t["x"].numpy().ravel(), t["y"].numpy().ravel()])
    _close(nt.vdot(a, b).numpy(), flat(a) @ flat(b))
    _close(nt.norm(a).numpy(), np.linalg.norm(flat(a)))
    _close(nt.norm(a, ord=float("inf")).numpy(), np.abs(flat(a)).max())
    _close(flat(nt.tree_axpy(2.0, a, b)), flat(b) + 2.0 * flat(a))
    v = nt.Vector(a) * 2.0 - nt.Vector(b)
    _close(flat(v.tree), 2.0 * flat(a) - flat(b))
    out = torch.func.jvp(lambda t: (t * 3.0).tree, (nt.Vector(a),), (nt.Vector(b),))[1]
    _close(flat(out), 3.0 * flat(b))
    g = torch.Generator().manual_seed(0)
    r = nt.random_like(
        g, {"x": nt.ShapeWithDtype((4,)), "y": nt.ShapeWithDtype((2,), torch.float64)}, device="cpu"
    )
    assert r["x"].shape == (4,) and r["y"].dtype == torch.float64


def test_kernel_wrappers_get_plain_tensors_under_torch_func(monkeypatch):
    """On the card a wrapper passes ``data_ptr()`` to its kernel, which a
    ``torch.func`` wrapped tensor does not have.  Every call of the four
    kernel wrappers in metric, LSM and RSM must see a plain tensor."""
    from nifty_tpu_torch.ops import cuda_fft
    from nifty_tpu_torch.ops import mode_expand as me

    seen = []

    def spy(module, name):
        fn = getattr(module, name)

        def wrapped(t, *args):
            t.data_ptr()  # raises for a functorch-wrapped tensor
            seen.append(name)
            return fn(t, *args)

        monkeypatch.setattr(module, name, wrapped)

    spy(me, "expand_to_grid")
    spy(me, "collapse_from_grid")
    spy(cuda_fft, "hartley_rows")
    spy(cuda_fft, "hartley_cols")
    ct = _cf(nt, (256, 256)).to(dtype=torch.float32)
    rng = np.random.default_rng(11)
    pos = nt.position_from_numpy(ct, {k: 0.3 * rng.standard_normal(v.shape) for k, v in ct.domain.items()})
    tan = nt.position_from_numpy(ct, {k: rng.standard_normal(v.shape) for k, v in ct.domain.items()})
    pos = {k: v.float() for k, v in pos.items()}
    tan = {k: v.float() for k, v in tan.items()}
    data = torch.from_numpy(rng.poisson(1.0, (256, 256)).astype(np.int32))
    lh = nt.Poissonian(data).amend(nt.ChainModel(torch.exp, ct))
    lh.metric(pos, tan)
    lh.left_sqrt_metric(pos, torch.ones(256, 256))
    lh.right_sqrt_metric(pos, tan)
    assert set(seen) == {"expand_to_grid", "collapse_from_grid", "hartley_rows", "hartley_cols"}
