"""Port parity: the Matérn correlated field (``MaternAmplitude`` in its
table and pixel forms, ``add_fluctuations_matern``), its Poisson metric,
and ``density_estimator``.

Both packages build the same model and get the same numpy-made position
and tangent; float64 on the CPU, tolerance 1e-10 of max|ref| (the same
closed-form spectrum; the renormalisation and the FFTs sum in other
orders).  The sizes: 24² (the JAX package's own test,
``tests/test_correlated_field.py:232``) and 256², both ``kind``s, with
and without renormalisation; the density estimator at (24,) and
(128, 128), padded to 48 and 256².
"""

import jax
import numpy as np
import pytest
import torch
from jax import numpy as jnp

import nifty_tpu as nj
import nifty_tpu_torch as nt

torch.set_num_threads(1)
TOL = 1e-10


def _close(got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * max(np.abs(want).max(), 1e-300))


def _build(pkg, shape, pixel, kind="amplitude", renormalize=True):
    cfm = pkg.CorrelatedFieldMaker("m")
    cfm.set_amplitude_total_offset(0.5, (1e-1, 3e-2))
    cfm.add_fluctuations_matern(shape, 1.0 / shape[0], scale=(1.0, 0.3), cutoff=(1.0, 0.5),
                                loglogslope=(-3.0, 0.3), renormalize_amplitude=renormalize,
                                non_parametric_kind=kind, pixel_expansion=pixel)
    return cfm.finalize() if pkg is nj else cfm.finalize(device="cpu", dtype=torch.float64)


def _draw(domain, seed):
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal(v.shape) for k, v in sorted(domain.items())}


CASES = [((24, 24), "amplitude", True), ((24, 24), "power", True), ((24, 24), "amplitude", False),
         ((256, 256), "amplitude", True), ((256, 256), "power", False), ((40, 24), "amplitude", True)]


@pytest.mark.parametrize("shape,kind,renorm", CASES)
@pytest.mark.parametrize("pixel", [False, True])
def test_matern_field(shape, kind, renorm, pixel):
    """Field, jvp and the amplitude's own call against the JAX package."""
    cj, ct = _build(nj, shape, pixel, kind, renorm), _build(nt, shape, pixel, kind, renorm)
    assert {k: v.shape for k, v in ct.domain.items()} == {k: tuple(v.shape) for k, v in cj.domain.items()}
    pos, tan = _draw(ct.domain, 1), _draw(ct.domain, 2)
    tp = nt.position_from_numpy(ct, pos)
    tt = nt.position_from_numpy(ct, tan)
    jp, jt = ({k: jnp.asarray(v) for k, v in t.items()} for t in (pos, tan))
    jy, jdy = jax.jvp(cj, (jp,), (jt,))
    ty, tdy = torch.func.jvp(ct, (tp,), (tt,))
    _close(ty, jy)
    _close(tdy, jdy)
    _close(ct.amplitudes[0](tp), cj.amplitudes[0](jp))
    assert ct.amplitudes[0].per_pixel is pixel
    assert ct.target.shape == tuple(shape)


@pytest.mark.parametrize("shape", [(24, 24), (256, 256)])
def test_matern_table_and_pixel_forms_agree(shape):
    tab, pix = _build(nt, shape, False), _build(nt, shape, True)
    p = nt.position_from_numpy(tab, _draw(tab.domain, 3))
    _close(pix(p), tab(p))


@pytest.mark.parametrize("shape,pixel", [((24, 24), False), ((24, 24), True), ((256, 256), False)])
def test_matern_poisson_metric(shape, pixel):
    cj, ct = _build(nj, shape, pixel), _build(nt, shape, pixel)
    counts = np.random.default_rng(4).poisson(2.0, shape)
    lj = nj.Poissonian(jnp.asarray(counts)).amend(lambda x: jnp.exp(cj(x)))
    lt = nt.Poissonian(counts, device="cpu").amend(nt.ChainModel(torch.exp, ct))
    pos, tan = _draw(ct.domain, 5), _draw(ct.domain, 6)
    want = lj.metric(nj.Vector({k: jnp.asarray(v) for k, v in pos.items()}),
                     nj.Vector({k: jnp.asarray(v) for k, v in tan.items()}))
    got = lt.metric(nt.position_from_numpy(ct, pos), nt.position_from_numpy(ct, tan))
    for k in got:
        _close(got[k], want.tree[k])
    _close(float(lt.energy(nt.position_from_numpy(ct, pos))),
           float(lj.energy(nj.Vector({k: jnp.asarray(v) for k, v in pos.items()}))))


@pytest.mark.parametrize("shape", [(24,), (128, 128)])
def test_density_estimator(shape):
    mj, pj = nj.density_estimator(shape)
    mt, pt = nt.density_estimator(shape, device="cpu", dtype=torch.float64)
    assert pt == pj == tuple(2 * s for s in shape)
    pos, tan = _draw(mt.domain, 7), _draw(mt.domain, 8)
    jp, jt = ({k: jnp.asarray(v) for k, v in t.items()} for t in (pos, tan))
    jy, jdy = jax.jvp(mj, (jp,), (jt,))
    ty, tdy = torch.func.jvp(mt, (nt.position_from_numpy(mt, pos),), (nt.position_from_numpy(mt, tan),))
    _close(ty, jy)
    _close(tdy, jdy)
    assert mt.correlated_field.target.shape == pt
