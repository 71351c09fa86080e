"""Port parity: the 64-knot correlated field and its relu-feature map.

Both packages build the same knot-form model (``n_mode_knots``) and get
the same numpy-made position, tangent and data.  Float64 on the CPU; the
forward, the amplitude at the knots, jvp, vjp and the Poisson metric agree
to rtol 1e-10 of max|ref| (exact algorithms in double precision; only the
FFT's and the knot chunks' summation orders differ).  The relu-feature
map is held against the JAX primitive ``_pwl_features_p`` (forward, vjp,
jvp) to 1e-12 and against its own adjoint to 1e-12 relative.
"""

import jax
import numpy as np
import pytest
import torch
from jax import numpy as jnp

import nifty_tpu as nj
import nifty_tpu_torch as nt
from nifty_tpu.models.correlated_field import _pwl_features_p
from nifty_tpu_torch.ops import cuda_fft, pwl

torch.set_num_threads(1)
RTOL = 1e-10
SHAPES = [(64, 64), (48, 80), (128,)]


def _close(a, b, rtol=RTOL):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    np.testing.assert_allclose(a, b, rtol=rtol, atol=rtol * max(np.abs(b).max(), 1e-300))


def _build(pkg, shape, knots, **kw):
    cfm = pkg.CorrelatedFieldMaker("cf")
    cfm.set_amplitude_total_offset(offset_mean=1.0, offset_std=(1e-1, 3e-2))
    cfm.add_fluctuations(
        shape,
        distances=1.0 / shape[0],
        fluctuations=(1.0, 5e-1),
        loglogavgslope=(-3.0, 2e-1),
        flexibility=(1e0, 2e-1),
        n_mode_knots=knots,
        **kw,
    )
    return cfm.finalize() if pkg is nj else cfm.finalize(device="cpu", dtype=torch.float64)


def _pair(shape, knots, seed=0, **kw):
    cj, ct = _build(nj, shape, knots, **kw), _build(nt, shape, knots, **kw)
    rng = np.random.default_rng(seed)
    pos = {k: rng.standard_normal(v.shape) for k, v in ct.domain.items()}
    tan = {k: rng.standard_normal(v.shape) for k, v in ct.domain.items()}
    return cj, ct, pos, tan


def _jax(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def _torch(model, tree):
    return nt.position_from_numpy(model, tree, dtype=torch.float64)


@pytest.mark.parametrize("knots", [8, 64])
@pytest.mark.parametrize("shape", SHAPES)
def test_knot_forward(shape, knots):
    cj, ct, pos, _ = _pair(shape, knots)
    assert {k: v.shape for k, v in ct.domain.items()} == {k: tuple(v.shape) for k, v in cj.domain.items()}
    _close(ct(_torch(ct, pos)).numpy(), cj(_jax(pos)))


@pytest.mark.parametrize("knots", [8, 64])
@pytest.mark.parametrize("shape", SHAPES)
def test_knot_amplitude_diagnostics(shape, knots):
    """The amplitude at the knots, and the normalised amplitude per core
    pixel and on the full grid."""
    cj, ct, pos, _ = _pair(shape, knots, seed=1)
    aj, at = cj.amplitudes[0], ct.amplitudes[0]
    pj, pt = _jax(pos), _torch(ct, pos)
    _close(at(pt).numpy(), aj(pj))
    azm_j, azm_t = cj.azm(pj), ct.azm(pt)
    _close(at.expanded_normalized_core(pt, azm_t).numpy(), aj.expanded_normalized_core(pj, azm_j))
    _close(at.expanded_normalized(pt, azm_t).numpy(), aj.expanded_normalized(pj, azm_j))


@pytest.mark.parametrize("knots", [8, 64])
@pytest.mark.parametrize("shape", SHAPES)
def test_knot_poisson_metric(shape, knots):
    cj, ct, pos, tan = _pair(shape, knots, seed=2)
    pos = {k: 0.5 * v for k, v in pos.items()}
    data = np.random.default_rng(3).poisson(1.0, size=shape).astype(np.int32)
    lhj = nj.Poissonian(jnp.asarray(data)).amend(nj.ChainModel(jnp.exp, cj))
    lht = nt.Poissonian(torch.from_numpy(data)).amend(nt.ChainModel(torch.exp, ct))
    want = lhj.metric(nj.Vector(_jax(pos)), nj.Vector(_jax(tan)))
    got = lht.metric(_torch(ct, pos), _torch(ct, tan))
    for k in want.tree:
        _close(got[k].numpy(), want[k])


@pytest.mark.parametrize("shape", [(48, 80), (128,)])
def test_knot_jvp_and_vjp(shape):
    cj, ct, pos, tan = _pair(shape, 64, seed=4)
    _, want = jax.jvp(cj, (_jax(pos),), (_jax(tan),))
    _, got = torch.func.jvp(ct, (_torch(ct, pos),), (_torch(ct, tan),))
    _close(got.numpy(), want)
    cot = np.random.default_rng(5).standard_normal(shape)
    _, fj = jax.vjp(cj, _jax(pos))
    _, ft = torch.func.vjp(ct, _torch(ct, pos))
    want, got = fj(jnp.asarray(cot))[0], ft(torch.from_numpy(cot))[0]
    for k in want:
        _close(got[k].numpy(), want[k])


def test_knot_power_kind_and_asperity():
    kw = dict(non_parametric_kind="power", asperity=(5e-1, 1e-1))
    cj, ct, pos, _ = _pair((40, 48), 16, seed=6, **kw)
    _close(ct(_torch(ct, pos)).numpy(), cj(_jax(pos)))
    _close(ct.amplitudes[0](_torch(ct, pos)).numpy(), cj.amplitudes[0](_jax(pos)))


def test_knot_grid_beside_an_exact_grid():
    """An exact 1-D subgrid and a knot 2-D subgrid in one model: one mode
    index (the exact one), the outer product of both spectra."""

    def build(pkg):
        cfm = pkg.CorrelatedFieldMaker("")
        cfm.set_amplitude_total_offset(offset_mean=0.5, offset_std=(1e-1, 3e-2))
        cfm.add_fluctuations((24,), 0.1, (1.0, 5e-1), (-2.0, 2e-1), (1e0, 2e-1), prefix="a")
        cfm.add_fluctuations((32, 40), 0.2, (1.0, 5e-1), (-3.0, 2e-1), (1e0, 2e-1), prefix="b",
                             n_mode_knots=12)
        return cfm.finalize() if pkg is nj else cfm.finalize(device="cpu", dtype=torch.float64)

    cj, ct = build(nj), build(nt)
    assert len(ct.indexes) == 1
    rng = np.random.default_rng(7)
    pos = {k: rng.standard_normal(v.shape) for k, v in ct.domain.items()}
    _close(ct(_torch(ct, pos)).numpy(), cj(_jax(pos)))


def test_knot_model_buffers_follow_device_and_dtype():
    """``finalize`` builds the per-pixel grids as buffers in the model's
    dtype (the mask stays boolean) and no mode index; ``.to`` carries
    them."""
    cfm = nt.CorrelatedFieldMaker("cf")
    cfm.set_amplitude_total_offset(offset_mean=1.0, offset_std=(1e-1, 3e-2))
    cfm.add_fluctuations((64, 48), 1 / 64, (1.0, 5e-1), (-3.0, 2e-1), (1e0, 2e-1), n_mode_knots=64)
    cf = cfm.finalize(device="cpu")
    amp = cf.amplitudes[0]
    assert len(cf.indexes) == 0
    assert amp.rel_log_k_core.shape == (33, 25) and amp.rel_log_k_core.dtype == torch.float32
    assert amp.nonzero_core.dtype == torch.bool and int((~amp.nonzero_core).sum()) == 1
    assert amp.knots.dtype == torch.float32 and amp.knots.shape == (64,)
    names = dict(cf.named_buffers())
    assert {"amplitudes.0.core_weight_0", "amplitudes.0.core_weight_1"} <= set(names)
    cf64 = cf.to(dtype=torch.float64)
    assert cf64.amplitudes[0].rel_log_k_core.dtype == torch.float64
    pos = nt.position_from_numpy(cf64, {k: np.zeros(v.shape) for k, v in cf64.domain.items()})
    assert all(v.dtype == torch.float64 for v in pos.values())
    assert torch.isfinite(cf64(pos)).all()


def _pwl_inputs(seed, core=(33, 41), knots=64):
    rng = np.random.default_rng(seed)
    x = np.abs(rng.standard_normal(core)) * 3.0
    t = np.linspace(0.0, x.max(), knots)
    return x, t, rng.standard_normal(knots - 1), rng.standard_normal(knots - 1), rng.standard_normal(core)


@pytest.mark.parametrize("knots", [2, 5, 64])
def test_pwl_features_match_jax(knots):
    """Forward, vjp (to coef) and jvp (in coef) against ``_pwl_features_p``."""
    x, t, c, tc, cot = _pwl_inputs(8, knots=knots)
    fj = lambda coef: _pwl_features_p.bind(jnp.asarray(x), jnp.asarray(t), coef)  # noqa: E731
    X, T = torch.from_numpy(x), torch.from_numpy(t)
    ft = lambda coef: pwl.PwlFeatures.apply(X, T, coef)  # noqa: E731
    _close(ft(torch.from_numpy(c)).numpy(), fj(jnp.asarray(c)), 1e-12)
    _, vj = jax.vjp(fj, jnp.asarray(c))
    _, vt = torch.func.vjp(ft, torch.from_numpy(c))
    _close(vt(torch.from_numpy(cot))[0].numpy(), vj(jnp.asarray(cot))[0], 1e-12)
    _, jj = jax.jvp(fj, (jnp.asarray(c),), (jnp.asarray(tc),))
    _, jt = torch.func.jvp(ft, (torch.from_numpy(c),), (torch.from_numpy(tc),))
    _close(jt.numpy(), jj, 1e-12)


def test_pwl_features_adjoint():
    """⟨A c, y⟩ = ⟨c, Aᵀ y⟩ for the map and its transpose."""
    x, t, c, _, y = _pwl_inputs(9, core=(129,))
    X, T = torch.from_numpy(x), torch.from_numpy(t)
    lhs = float(torch.dot(pwl.pwl_features(X, T, torch.from_numpy(c)), torch.from_numpy(y)))
    rhs = float(torch.dot(torch.from_numpy(c), pwl.pwl_transpose(X, T, torch.from_numpy(y))))
    assert abs(lhs - rhs) <= 1e-12 * abs(lhs)


def test_pwl_features_never_hold_the_feature_tensor(monkeypatch):
    """Every temporary of the map, both ways, is at most KNOT_CHUNK times
    the core grid: the (pixels, K) tensor is never made."""
    sizes = []
    features = pwl._features

    def spy(x, t):
        out = features(x, t)
        sizes.append(out.numel() / x.numel())
        return out

    monkeypatch.setattr(pwl, "_features", spy)
    x, t, c, _, y = _pwl_inputs(10, knots=64)
    X, T = torch.from_numpy(x), torch.from_numpy(t)
    pwl.pwl_features(X, T, torch.from_numpy(c))
    pwl.pwl_transpose(X, T, torch.from_numpy(y))
    assert len(sizes) == 2 * -(-63 // pwl.KNOT_CHUNK)  # every chunk of the 63 slopes, both ways
    assert max(sizes) == pwl.KNOT_CHUNK < 63


def test_batched_hartley_goes_through_the_kernel_pair(monkeypatch):
    """A (B, n0, n1) f32 grid with axes (1, 2) in the kernels' domain runs
    Hartley2d, one K3 + K4 pair per slice (here their plain versions), and
    equals the plain transform; other axes and dtypes do not."""
    calls = []
    hartley2d = cuda_fft.hartley2d

    def spy(x):
        calls.append(tuple(x.shape))
        return hartley2d(x)

    monkeypatch.setattr(cuda_fft, "hartley2d", spy)
    x = torch.from_numpy(np.random.default_rng(11).standard_normal((3, 256, 512))).float()
    out = nt.hartley(x, axes=(1, 2))
    assert calls == [(256, 512)] * 3
    ref = nt.ops.fft.hartley_plain(x.double(), axes=(1, 2))
    assert float((out.double() - ref).abs().max() / ref.abs().max()) <= 1e-5
    _, vjp_fn = torch.func.vjp(lambda v: nt.hartley(v, axes=(-2, -1)), x)
    calls.clear()
    vjp_fn(x)
    assert calls == [(256, 512)] * 3  # Hᵀ = H, slice by slice
    calls.clear()
    nt.hartley(x, axes=(0, 1))
    nt.hartley(x.double(), axes=(1, 2))
    assert calls == []
