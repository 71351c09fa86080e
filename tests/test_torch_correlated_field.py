"""Port parity: the exact-spectrum correlated field and its parts.

Both packages build the same model and get the same numpy-made position
and tangent through ``interop.position_from_numpy``.  Everything runs in
float64 on the CPU and agrees to rtol 1e-10 of max|ref| (exact algorithms
in double precision; only FFT and summation order differ).
"""

import jax
import numpy as np
import pytest
import torch
from jax import numpy as jnp

import nifty_tpu as nj
import nifty_tpu_torch as nt
from nifty_tpu.models.gauss_markov import integrated_wiener_process as jax_iwp
from nifty_tpu.models.correlated_field import _mirror_unfold as jax_mirror_unfold
from nifty_tpu_torch.ops.cuda_expand import mirror_unfold

torch.set_num_threads(1)
RTOL = 1e-10


def _close(a, b, rtol=RTOL):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    np.testing.assert_allclose(a, b, rtol=rtol, atol=rtol * max(np.abs(b).max(), 1e-300))


def _build(pkg, shape, **kw):
    cfm = pkg.CorrelatedFieldMaker("cf")
    cfm.set_amplitude_total_offset(offset_mean=1.0, offset_std=(1e-1, 3e-2))
    cfm.add_fluctuations(
        shape,
        distances=1.0 / shape[0],
        fluctuations=(1.0, 5e-1),
        loglogavgslope=(-3.0, 2e-1),
        flexibility=(1e0, 2e-1),
        **kw,
    )
    return cfm.finalize() if pkg is nj else cfm.finalize(device="cpu", dtype=torch.float64)


def _pair(shape, seed=0, **kw):
    cj, ct = _build(nj, shape, **kw), _build(nt, shape, **kw)
    rng = np.random.default_rng(seed)
    pos = {k: rng.standard_normal(v.shape) for k, v in ct.domain.items()}
    tan = {k: rng.standard_normal(v.shape) for k, v in ct.domain.items()}
    return cj, ct, pos, tan


def _jax(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def _torch(model, tree):
    return nt.position_from_numpy(model, tree, dtype=torch.float64)


def test_domain_matches_jax():
    cj, ct, _, _ = _pair((48, 48))
    dj = {k: tuple(v.shape) for k, v in cj.domain.items()}
    assert {k: v.shape for k, v in ct.domain.items()} == dj


@pytest.mark.parametrize("shape", [(48, 48), (48, 64)])
def test_forward(shape):
    cj, ct, pos, _ = _pair(shape)
    _close(ct(_torch(ct, pos)).numpy(), cj(_jax(pos)))


@pytest.mark.parametrize("shape", [(48, 48), (48, 64)])
def test_jvp(shape):
    cj, ct, pos, tan = _pair(shape, seed=1)
    _, want = jax.jvp(cj, (_jax(pos),), (_jax(tan),))
    _, got = torch.func.jvp(ct, (_torch(ct, pos),), (_torch(ct, tan),))
    _close(got.numpy(), want)


@pytest.mark.parametrize("shape", [(48, 48), (48, 64)])
def test_vjp(shape):
    cj, ct, pos, _ = _pair(shape, seed=2)
    cot = np.random.default_rng(3).standard_normal(shape)
    _, fj = jax.vjp(cj, _jax(pos))
    _, ft = torch.func.vjp(ct, _torch(ct, pos))
    want, got = fj(jnp.asarray(cot))[0], ft(torch.from_numpy(cot))[0]
    for k in want:
        _close(got[k].numpy(), want[k])


def test_amplitude_spectrum():
    cj, ct, pos, _ = _pair((48, 64), seed=4)
    _close(ct.amplitudes[0](_torch(ct, pos)).numpy(), cj.amplitudes[0](_jax(pos)))


def test_power_kind_and_asperity():
    kw = dict(non_parametric_kind="power", asperity=(5e-1, 1e-1))
    cj, ct, pos, _ = _pair((32, 40), seed=5, **kw)
    _close(ct(_torch(ct, pos)).numpy(), cj(_jax(pos)))


def test_two_subgrids_outer_product():
    def build(pkg):
        cfm = pkg.CorrelatedFieldMaker("")
        cfm.set_amplitude_total_offset(offset_mean=0.5, offset_std=(1e-1, 3e-2))
        cfm.add_fluctuations((24,), 0.1, (1.0, 5e-1), (-2.0, 2e-1), (1e0, 2e-1), prefix="a")
        cfm.add_fluctuations((10, 12), 0.2, (1.0, 5e-1), (-3.0, 2e-1), None, prefix="b")
        return cfm.finalize() if pkg is nj else cfm.finalize(device="cpu", dtype=torch.float64)

    cj, ct = build(nj), build(nt)
    rng = np.random.default_rng(6)
    pos = {k: rng.standard_normal(v.shape) for k, v in ct.domain.items()}
    _close(ct(_torch(ct, pos)).numpy(), cj(_jax(pos)))


def test_integrated_wiener_process():
    rng = np.random.default_rng(7)
    xi = rng.standard_normal((30, 2))
    dt = rng.uniform(0.1, 1.0, 30)
    x0 = np.array([0.3, -0.2])
    want = jax_iwp(jnp.asarray(xi), jnp.asarray(x0), 0.7, jnp.asarray(dt), asperity=0.1)
    got = nt.integrated_wiener_process(
        torch.from_numpy(xi), torch.from_numpy(x0), 0.7, torch.from_numpy(dt), asperity=0.1
    )
    _close(got.numpy(), want)


@pytest.mark.parametrize("prior", ["normal", "lognormal"])
def test_priors(prior):
    from nifty_tpu.num import stats_distributions as sj

    xi = np.random.default_rng(8).standard_normal(5)
    fj = getattr(sj, f"{prior}_prior")(1.5, 0.3)
    ft = getattr(nt, f"{prior}_prior")(1.5, 0.3)
    _close(ft(torch.from_numpy(xi)).numpy(), fj(jnp.asarray(xi)))
    _close(np.asarray(nt.lognormal_moments(2.0, 0.5)), np.asarray(sj.lognormal_moments(2.0, 0.5)))


@pytest.mark.parametrize("core,full", [((5, 7), (8, 12)), ((4,), (7,)), ((3, 4, 5), (4, 6, 9))])
def test_mirror_unfold(core, full):
    x = np.random.default_rng(9).standard_normal(core)
    _close(mirror_unfold(torch.from_numpy(x), full).numpy(), jax_mirror_unfold(jnp.asarray(x), full))


def test_mode_distributor_matches_jax():
    want = nj.get_fourier_mode_distributor((20, 30), (0.1, 0.2))
    got = nt.get_fourier_mode_distributor((20, 30), (0.1, 0.2))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_knot_form_is_refused():
    """The knot form is ported (tests/test_torch_knot.py); it refuses fewer
    than two knots, as the JAX package does."""
    cfm = nt.CorrelatedFieldMaker("cf")
    with pytest.raises(ValueError, match="two spectral knots"):
        cfm.add_fluctuations((16, 16), 1 / 16, (1.0, 5e-1), (-3.0, 2e-1), n_mode_knots=1)


def test_position_from_numpy_checks_keys_and_shapes():
    ct = _build(nt, (16, 16))
    rng = np.random.default_rng(10)
    pos = {k: rng.standard_normal(v.shape) for k, v in ct.domain.items()}
    out = nt.position_from_numpy(ct, pos, dtype=torch.float32)
    assert all(v.dtype == torch.float32 for v in out.values())
    with pytest.raises(KeyError):
        nt.position_from_numpy(ct, {k: v for k, v in pos.items() if k != "cfxi"})
    bad = dict(pos, cfxi=np.zeros((16, 17)))
    with pytest.raises(ValueError):
        nt.position_from_numpy(ct, bad)


def test_position_from_numpy_takes_a_domain_tree_and_a_chain_axis():
    """A domain may be a tree itself (a likelihood's ``(mean, std_inv)``
    pair, a complex leaf keeping its dtype) and the arrays may carry
    leading chain axes, which are checked with the shapes."""
    ct = _build(nt, (16, 16))
    rng = np.random.default_rng(11)
    pos = {k: rng.standard_normal((3,) + v.shape) for k, v in ct.domain.items()}
    out = nt.position_from_numpy(ct, pos, batch=(3,))
    assert all(out[k].shape == (3,) + ct.domain[k].shape for k in pos)
    with pytest.raises(ValueError):
        nt.position_from_numpy(ct, pos)
    pair = (nt.ShapeWithDtype((4,), torch.complex128), nt.ShapeWithDtype((4,)))
    mean, std_inv = nt.position_from_numpy(
        pair, (rng.standard_normal(4) + 1j, rng.uniform(size=4)), device="cpu", dtype=torch.float32)
    assert mean.dtype == torch.complex128 and std_inv.dtype == torch.float32
    with pytest.raises(ValueError):
        nt.position_from_numpy(pair, (np.zeros(4), np.zeros(5)), device="cpu")


def test_model_moves_to_float32():
    ct = _build(nt, (16, 16)).to(dtype=torch.float32)
    assert ct.indexes[0].idx.dtype == torch.int32
    assert ct.amplitudes[0].relative_log_mode_lengths.dtype == torch.float32
    p = ct.init(torch.Generator().manual_seed(0), device="cpu", dtype=torch.float32)
    out = ct(p)
    assert out.dtype == torch.float32 and out.shape == (16, 16)
    assert torch.isfinite(out).all()
