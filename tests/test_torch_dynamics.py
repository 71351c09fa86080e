"""The port's dynamics priors against nifty_tpu on the CPU, float64.

Signed FFT coordinates, the light cone (values and the gradient in the
lightspeeds, finite at the grid origin's sqrt branch point), the causal
and minimum-phase transfer fields, and the light-cone operator's value,
jvp and vjp on its real latents.  A JAX vjp of the complex output with
cotangent ``c`` is torch's vjp with ``conj(c)``.  Tolerance: 1e-12
relative to each output's maximum (the same FFTs and elementwise maps).
"""

import jax
import numpy as np
import pytest
import torch
from jax import numpy as jnp

import nifty_tpu.models.dynamics as jd
import nifty_tpu_torch.models.dynamics as td

torch.set_num_threads(1)
TOL = 1e-12


def _close(a, b, tol=TOL):
    a, b = np.asarray(a), np.asarray(b)
    np.testing.assert_allclose(a, b, rtol=tol, atol=tol * np.abs(b).max())


def _latent(domain, seed):
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal(v.shape) for k, v in sorted(domain.items())}


def test_signed_fft_coords():
    for shape, dist, absolute in (((8,), (0.5,), False), ((5, 6), (1.0, 0.3), True),
                                  ((4, 3, 7), (1.0, 2.0, 0.5), False)):
        np.testing.assert_array_equal(td.signed_fft_coords(shape, dist, absolute),
                                      jd.signed_fft_coords(shape, dist, absolute))


@pytest.mark.parametrize("shape", [(16, 16), (12, 10, 6)])
def test_light_cone_and_its_gradient(shape):
    dist = (1.0, 0.7, 1.3)[: len(shape)]
    c = np.linspace(0.8, 1.4, len(shape) - 1)
    ref = jd.light_cone(jnp.asarray(c), shape, dist, 2.0)
    got = td.light_cone(torch.from_numpy(c), shape, dist, 2.0)
    _close(got.numpy(), ref)
    w = np.random.default_rng(0).standard_normal(shape)
    g_j = jax.grad(lambda q: jnp.sum(w * jd.light_cone(q, shape, dist, 2.0)))(jnp.asarray(c))
    g_t = torch.func.grad(lambda q: (torch.from_numpy(w) * td.light_cone(q, shape, dist, 2.0)).sum())(
        torch.from_numpy(c))
    assert np.isfinite(g_t.numpy()).all()  # the origin's branch point is guarded
    _close(g_t.numpy(), g_j)
    assert td.light_cone(torch.from_numpy(c).float(), shape, dist, 2.0).dtype == torch.float32


CASES = {
    "causal_padded": dict(shape=(32, 8), sm_x0=2.0, harmonic_padding=8, causal=True),
    "acausal": dict(shape=(16, 12), sm_x0=(2.0, 3.0), harmonic_padding=(4, 2), causal=False),
    "minimum_phase": dict(shape=(32,), sm_x0=3.0, causal=True, minimum_phase=True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_dynamic_operator_matches_the_reference(case):
    kw = dict(CASES[case], distances=1.0, key="dyn", sm_s0=0.7)
    mj, ops_j = jd.dynamic_operator(**kw)
    mt, ops_t = td.dynamic_operator(**kw)
    assert {k: v.shape for k, v in mt.domain.items()} == {k: v.shape for k, v in mj.domain.items()}
    np.testing.assert_array_equal(ops_t["smoothness_weight"], ops_j["smoothness_weight"])
    np.testing.assert_array_equal(ops_t["causal_mask"], ops_j["causal_mask"])
    p = _latent(mt.domain, 1)
    pj, pt = {k: jnp.asarray(v) for k, v in p.items()}, {k: torch.from_numpy(v) for k, v in p.items()}
    out = mt(pt)
    assert out.dtype == torch.complex128 and tuple(out.shape) == kw["shape"]
    _close(out.numpy(), mj(pj))
    _close(ops_t["smoothed_dynamics"](pt).numpy(), ops_j["smoothed_dynamics"](pj))
    if kw["causal"] and not kw.get("minimum_phase"):
        kern = np.fft.ifftn(out.numpy())
        t = td.signed_fft_coords(kw["shape"], (1.0,) * len(kw["shape"]))[0]
        assert np.abs(kern[t < 0]).max() < 1e-10 * np.abs(kern[t > 0]).max()
    assert mt(pt | {"dyn": pt["dyn"].float()}).dtype == torch.complex64


def test_dynamic_lightcone_operator_value_jvp_vjp():
    kw = dict(shape=(16, 12), distances=(1.0, 0.5), key="dyn", lightcone_key="speed", sm_s0=1.0,
              sm_x0=2.0, sigc=0.3, quant=2.0, harmonic_padding=(4, 4))
    mj, ops_j = jd.dynamic_lightcone_operator(**kw)
    mt, ops_t = td.dynamic_lightcone_operator(**kw)
    assert list(mt.domain) == sorted(mj.domain) == ["dyn", "speed"]
    p, t = _latent(mt.domain, 2), _latent(mt.domain, 3)
    rng = np.random.default_rng(4)
    c = rng.standard_normal(kw["shape"]) + 1j * rng.standard_normal(kw["shape"])
    j = lambda d: {k: jnp.asarray(v) for k, v in d.items()}  # noqa: E731
    tt = lambda d: {k: torch.from_numpy(v) for k, v in d.items()}  # noqa: E731
    y_j, jt_j = jax.jvp(mj, (j(p),), (j(t),))
    y_t, jt_t = torch.func.jvp(mt, (tt(p),), (tt(t),))
    _close(y_t.numpy(), y_j)
    _close(jt_t.numpy(), jt_j)
    g_j = jax.vjp(mj, j(p))[1](jnp.asarray(c))[0]
    g_t = torch.func.vjp(mt, tt(p))[1](torch.from_numpy(c.conj()))[0]
    for k in p:
        _close(g_t[k].numpy(), g_j[k])
    _close(ops_t["lightspeed"](tt(p)).numpy(), ops_j["lightspeed"](j(p)))
    _close(ops_t["light_cone"](tt(p)).numpy(), ops_j["light_cone"](j(p)))
    # the gradient of a real loss reaches the lightspeed latent
    g = torch.func.grad(lambda q: (mt(q).abs() ** 2).sum())(tt(p))
    assert float(g["speed"].abs().max()) > 0
    with pytest.raises(ValueError):
        td.dynamic_lightcone_operator(**dict(kw, shape=(16,), distances=1.0))


def test_float32_transfer_field_holds_float64():
    """The transfer field is 1/m: near the zeros of the Gaussian m float32's
    rounding is a large relative error, so the model computes in complex128
    and rounds its output once.  At float32 inputs the complex64 value and
    jvp stay within 1e-6 of float64 at the same inputs (relative L2; the
    arithmetic in float32 gives 1.8e-5)."""
    shape = (128, 256)
    mt, _ = td.dynamic_lightcone_operator(shape=shape, distances=(1.0 / 128, 1.0 / 256), key="dyn",
                                          lightcone_key="speed", sm_s0=1.0, sm_x0=(8.0, 8.0),
                                          sigc=0.3, quant=2.0, harmonic_padding=(16, 16))
    p = {k: torch.from_numpy(v).float() for k, v in _latent(mt.domain, 6).items()}
    t = {k: torch.from_numpy(v).float() for k, v in _latent(mt.domain, 7).items()}
    y32, j32 = torch.func.jvp(mt, (p,), (t,))
    y64, j64 = torch.func.jvp(mt, ({k: v.double() for k, v in p.items()},),
                              ({k: v.double() for k, v in t.items()},))
    assert y32.dtype == torch.complex64
    for a, b in ((y32, y64), (j32, j64)):
        assert float((a.to(b.dtype) - b).norm() / b.norm()) <= 1e-6


def test_float32_light_cone_holds_float64():
    """Near the cone's edge t² and Σ c x² cancel: the window is computed in
    float64 and rounded once, so a float32 cone (and its gradient in the
    lightspeeds) at (512, 1024) stays within 1e-6 (1e-5) of float64 (an
    f32 interval is off by 1e-4)."""
    shape, dist = (512, 1024), (1.0 / 512, 1.0 / 1024)
    c = torch.tensor([1.37], dtype=torch.float32)
    w = torch.from_numpy(np.random.default_rng(8).standard_normal(shape))

    def grad(q):
        return torch.func.grad(lambda v: (w.to(v.dtype) * td.light_cone(v, shape, dist, 2.0)).sum())(q)

    cone32, cone64 = td.light_cone(c, shape, dist, 2.0), td.light_cone(c.double(), shape, dist, 2.0)
    assert cone32.dtype == torch.float32
    assert float((cone32.double() - cone64).abs().max()) <= 1e-6
    g32, g64 = grad(c), grad(c.double())
    assert float((g32.double() - g64).abs().max() / g64.abs().max()) <= 1e-5
