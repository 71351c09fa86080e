"""Port parity: the correlated field on the HEALPix sphere.

The same numpy positions, data, tangents and white noise go through the
JAX package's model and the port's, float64 on the CPU.  Tolerances: the
mode binning exact; the forward (alone and as an outer product with a
regular axis), the Gaussian likelihood's metric and an MGVI residual
(6 CG iterations from the JAX package's own draws) 1e-10 of the largest
value (the synthesis rounds differently, see ``test_torch_sht.py``).
"""

from functools import partial

import jax
import numpy as np
import pytest
import torch
from jax import numpy as jnp
from jax import random

import nifty_tpu as nj
import nifty_tpu_torch as nt
from nifty_tpu.utils.tree import random_like as jax_random_like
from nifty_tpu_torch.model import eval_shape
from nifty_tpu_torch.ops import cuda_legendre as cl

torch.set_num_threads(1)
NSIDE = 4


def _close(got, want, rtol=1e-10):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * max(np.abs(want).max(), 1e-300))


def _sky(mod, regular=None, **kw):
    cfm = mod.CorrelatedFieldMaker("sky")
    cfm.set_amplitude_total_offset(offset_mean=0.1, offset_std=(1e-1, 3e-2))
    cfm.add_fluctuations((NSIDE,), distances=None, fluctuations=(1.0, 0.5),
                         loglogavgslope=(-3.0, 0.5), flexibility=(1.0, 0.3), asperity=(0.5, 0.2),
                         harmonic_type="spherical", prefix="s")
    if regular:
        cfm.add_fluctuations((regular,), distances=1.0 / regular, fluctuations=(1.0, 0.5),
                             loglogavgslope=(-2.0, 0.5), prefix="r")
    return cfm.finalize(**kw)


def _pair(regular=None):
    cj = _sky(nj, regular)
    ct = _sky(nt, regular, device="cpu", dtype=torch.float64)
    rng = np.random.default_rng(regular or 0)
    pos = {k: 0.5 * rng.standard_normal(v.shape) for k, v in sorted(ct.domain.items())}
    return cj, ct, pos


def test_spherical_grid_and_distributor_match_jax():
    gj = nj.make_grid((NSIDE,), None, "spherical")
    gt = nt.make_grid((NSIDE,), None, "spherical")
    assert (gt.nside, gt.shape, gt.total_volume) == (gj.nside, gj.shape, gj.total_volume)
    for f in gj.harmonic_grid._fields:
        np.testing.assert_array_equal(np.asarray(getattr(gt.harmonic_grid, f)),
                                      np.asarray(getattr(gj.harmonic_grid, f)))
    for lmax, mmax in ((8, 8), (8, 3)):
        (a, b) = nt.get_spherical_mode_distributor(NSIDE, lmax, mmax), nj.get_spherical_mode_distributor(
            NSIDE, lmax, mmax)
        for u, v in zip(a[0], b[0]):
            np.testing.assert_array_equal(u, v)
        assert a[1] == b[1]
    with pytest.raises(TypeError, match="regular Cartesian"):
        nt.CorrelatedFieldMaker("x").add_fluctuations(
            (NSIDE,), None, (1.0, 0.5), (-3.0, 0.5), harmonic_type="spherical", n_mode_knots=8)


@pytest.mark.parametrize("regular", [None, 16])
def test_spherical_field_forward_matches_jax(regular):
    """The field alone and times a regular 16-pixel axis (the Hartley over
    the regular axis, the synthesis over the sphere's); the l table goes
    onto the packed alm through K1's flat 1-D layout."""
    cj, ct, pos = _pair(regular)
    assert sorted(cj.domain) == sorted(ct.domain)
    got = ct(nt.position_from_numpy(ct, pos))
    _close(got.numpy(), jax.jit(cj)({k: jnp.asarray(v) for k, v in pos.items()}))
    index = ct.indexes[0]
    size = cl.alm_size(2 * NSIDE, 2 * NSIDE)
    assert index.layout.kind == "flat" and index.layout.core_shape == (size,)
    assert eval_shape(ct, ct.domain).shape == tuple(got.shape)


def _gaussian_pair(regular=None):
    cj, ct, pos = _pair(regular)
    rng = np.random.default_rng(7)
    shape = tuple(ct(nt.position_from_numpy(ct, pos)).shape)
    data = rng.standard_normal(shape)
    lhj = nj.Gaussian(jnp.asarray(data), noise_cov_inv=lambda x: x / 0.04).amend(cj)
    lht = nt.Gaussian(torch.from_numpy(data), noise_cov_inv=lambda x: x / 0.04).amend(ct)
    return lhj, lht, ct, pos


@pytest.mark.parametrize("regular", [None, 16])
def test_spherical_metric_matches_jax(regular):
    lhj, lht, ct, pos = _gaussian_pair(regular)
    tan = {k: np.random.default_rng(8).standard_normal(v.shape) for k, v in pos.items()}
    pj = {k: jnp.asarray(v) for k, v in pos.items()}
    tj = {k: jnp.asarray(v) for k, v in tan.items()}
    want = jax.jit(lhj.metric)(pj, tj)
    got = lht.metric(nt.position_from_numpy(ct, pos), nt.position_from_numpy(ct, tan))
    for k in pos:
        _close(got[k].numpy(), want[k])


def test_spherical_metric_under_vmap_matches_a_loop():
    """Tangents as one batch (K5/K6 once per batch) against one at a time."""
    _, lht, ct, pos = _gaussian_pair()
    rng = np.random.default_rng(9)
    tans = {k: rng.standard_normal((3,) + v.shape) for k, v in pos.items()}
    p = nt.position_from_numpy(ct, pos)
    t = nt.position_from_numpy(ct, tans, batch=(3,))
    batched = torch.func.vmap(partial(lht.metric, p))(t)
    for i in range(3):
        one = lht.metric(p, {k: v[i] for k, v in t.items()})
        for k in one:
            _close(batched[k][i].numpy(), one[k].numpy(), 1e-12)


def test_spherical_mgvi_residual_matches_jax():
    """One MGVI residual, 6 CG iterations, from the JAX package's draws."""
    lhj, lht, ct, pos = _gaussian_pair()
    pj = {k: jnp.asarray(v) for k, v in pos.items()}
    key = random.PRNGKey(3)
    kw = dict(cg_kwargs=dict(maxiter=6, miniter=6, resnorm=-1.0))
    sj, ij = jax.jit(partial(nj.draw_linear_residual, lhj, **kw))(pj, key)
    lh, p_liquid = lhj.freeze(point_estimates=(), primals=pj)
    k_nll, k_prr = random.split(key, 2)
    data = np.array(jax_random_like(k_nll, lh.left_sqrt_metric_tangents_shape))
    prior = jax_random_like(k_prr, p_liquid)
    white = nt.WhiteNoise(torch.from_numpy(data), {
        k: torch.from_numpy(np.array(v)) for k, v in zip(sorted(pos), jax.tree_util.tree_leaves(prior))})
    st, it = nt.draw_linear_residual(lht, nt.position_from_numpy(ct, pos), white=white, **kw)
    assert int(it) == int(ij) == 6
    for k in pos:
        _close(st[k].numpy(), sj[k])
