"""Port parity: the multi-grid ICR fields and what they are built from.

The same numpy excitations and positions go through the JAX package's
``nifty_tpu.multi_grid`` and the port's, float64 on the CPU.  Tolerances:
the host geometry (the tolerant uniqueness, the grids' shapes and
coordinates) exact; the fields, their metrics and the Matérn covariance
1e-9 of the largest value (the same stencils and matrices; LAPACK's
Cholesky and solve, the convolutions and the einsums sum in other
orders).

The JAX package's HEALPix charts need its C++ HEALPix library, which its
own loader writes straight onto its final path; several test processes
loading it at once can read a half-written file.  The fixture
``native_healpix`` builds it first under a file lock, into a temporary
file moved into place, with the loader's own command line, so the
reference always loads a whole library.  The port needs no such library.
"""

import fcntl
import importlib
import os
import subprocess
from functools import partial

import jax
import numpy as np
import pytest
import torch
from jax import numpy as jnp

import nifty_tpu as nj
import nifty_tpu.multi_grid as jm
import nifty_tpu_torch as nt
import nifty_tpu_torch.multi_grid as tm
from nifty_tpu_torch.multi_grid.matern import IsotropicPowerSpectrumTransform, bessel_j0

torch.set_num_threads(1)
F64 = dict(device="cpu", dtype=torch.float64)
# the modules (``nifty_tpu.num`` exports a function of the same name)
ju = importlib.import_module("nifty_tpu.num.unique")
tu = importlib.import_module("nifty_tpu_torch.num.unique")


@pytest.fixture(scope="module")
def native_healpix():
    import nifty_tpu.native as native

    here = os.path.dirname(native.__file__)
    lib, src = os.path.join(here, "_libnifty_healpix.so"), os.path.join(here, "healpix.cc")
    with open(lib + ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not os.path.exists(lib) or os.path.getmtime(lib) < os.path.getmtime(src):
            tmp = f"{lib}.{os.getpid()}.tmp"
            subprocess.run(["g++", "-O3", "-march=native", "-std=c++17", "-shared", "-fPIC",
                            "-fopenmp", src, "-o", tmp], check=True, capture_output=True)
            os.replace(tmp, lib)
    assert native.native_available()


def _close(got, want, rtol=1e-9):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * max(np.abs(want).max(), 1e-300))


def _levels(shapes, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s) for s in shapes]


# --- the tolerant uniqueness and the grids --------------------------------------


def test_unique_matches_jax():
    rng = np.random.default_rng(0)
    base = rng.standard_normal((4, 3))
    ar = base[rng.integers(0, 4, 20)] + 1e-12 * rng.standard_normal((20, 3))
    for axis in (0, -1):
        a = ar if axis == 0 else ar.T
        for x, y in zip(tu.unique(a, return_inverse=True, axis=axis),
                        ju.unique(a, return_inverse=True, axis=axis)):
            np.testing.assert_array_equal(x, y)
    for el in (base[2], base[2] + 1.0):
        x, i = tu.amend_unique(base, el, axis=0)
        y, j = ju.amend_unique(base, el, axis=0)
        np.testing.assert_array_equal(x, y)
        assert i == j
    buf = np.full((6, 3), np.nan)
    buf[:4] = base
    for el in (base[1], base[1] + 1.0):
        x, i = tu.amend_unique_(torch.from_numpy(buf), torch.from_numpy(el), axis=0)
        y, j = ju.amend_unique_(jnp.asarray(buf), jnp.asarray(el), axis=0)
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))
        assert int(i) == int(j)


GRIDS = {
    "open_2d": lambda M: M.SimpleOpenGrid(shape0=(6, 5), depth=2, distances0=(1.0, 0.7), padding=1),
    "open_1d_splits3": lambda M: M.SimpleOpenGrid(shape0=(7,), depth=2, splits=3, padding=1),
    "open_3d": lambda M: M.SimpleOpenGrid(shape0=(4, 4, 4), depth=1, padding=1),
    "log": lambda M: M.LogGrid(shape0=8, depth=2, r_min=1.0, r_max=10.0),
    "open_x_log": lambda M: M.MGrid(M.SimpleOpenGrid(shape0=(5,), depth=2),
                                    M.LogGrid(shape0=6, depth=2, r_min=1.0, r_max=10.0)),
    "log_x_brokenlog": lambda M: M.MGrid(
        M.LogGrid(shape0=6, depth=2, r_min=1.0, r_max=10.0),
        M.BrokenLogGrid(shape0=7, depth=2, r_min=1.0, r_linthresh=3.0, r_max=10.0)),
}


@pytest.mark.parametrize("name", sorted(GRIDS))
def test_grids_and_icr_kernel_match_jax(name):
    """Shapes and level coordinates exact; ``ICRKernel.apply`` with a fixed
    exponential covariance (one stencil, per-shell and per-block levels;
    1-3 axes)."""
    gj, gt = GRIDS[name](jm), GRIDS[name](tm)
    assert gt.shapes == gj.shapes
    for lvl in range(gj.depth + 1):
        idx = np.stack(np.meshgrid(*[np.arange(n) for n in gj.shapes[lvl]], indexing="ij"))
        np.testing.assert_array_equal(gt.at(lvl).index2coord(idx), gj.at(lvl).index2coord(idx))
    kj = jm.ICRKernel(gj, lambda r: jnp.exp(-r / 3.0))
    kt = tm.ICRKernel(gt, lambda r: torch.exp(-r / 3.0)).to(torch.float64)
    xs = _levels(gj.shapes, 1)
    _close(kt.apply([torch.from_numpy(x) for x in xs]).numpy(),
           jax.jit(kj.apply)([jnp.asarray(x) for x in xs]))


def test_matern_covariance_matches_jax():
    r = np.geomspace(1e-3, 30.0, 50)
    _close(bessel_j0(torch.from_numpy(r)).numpy(), jm.matern.bessel_j0(jnp.asarray(r)), 1e-13)
    for ndim in (1, 2, 3):
        args = dict(ndim=ndim, r_min=0.05, r_max=20.0, n_integrate=400, n_interpolate=64)
        fj = jm.matern_spectral_covariance(**args)(1.3, 2.0, -3.5)
        ft = tm.matern_spectral_covariance(**args)(*(torch.tensor(v, dtype=torch.float64)
                                                     for v in (1.3, 2.0, -3.5)))
        _close(ft(torch.from_numpy(r)).numpy(), fj(jnp.asarray(r)))
        tj = jm.matern.IsotropicPowerSpectrumTransform(ndim, n_nodes=512)
        tt = IsotropicPowerSpectrumTransform(ndim, n_nodes=512)
        _close(tt(lambda k: torch.exp(-0.5 * k**2), torch.from_numpy(r)).numpy(),
               tj(lambda k: jnp.exp(-0.5 * k**2), jnp.asarray(r)))


def _numpy_position(p):
    return {k: [np.asarray(u) for u in v] if isinstance(v, list) else np.asarray(v)
            for k, v in p.items()}


def _matern(mod):
    return mod.MaternCovarianceModel(ndim=2, r_min=0.05, r_max=20.0, scale=(1.0, 0.3),
                                     cutoff=(2.0, 0.5), loglogslope=(-3.5, 0.5), n_integrate=300,
                                     n_interpolate=64)


def _metric_matches(fj, ft, pos, seed):
    """The Gaussian likelihood's metric at ``pos`` on a numpy tangent."""
    rng = np.random.default_rng(seed)
    tan = {k: [rng.standard_normal(u.shape) for u in v] if isinstance(v, list)
           else rng.standard_normal(v.shape) for k, v in pos.items()}
    jt = lambda d: {k: [jnp.asarray(u) for u in v] if isinstance(v, list)  # noqa: E731
                    else jnp.asarray(v) for k, v in d.items()}
    pt = nt.position_from_numpy(ft, pos)
    data = rng.standard_normal(tuple(ft(pt).shape))
    lhj = nj.Gaussian(jnp.asarray(data), noise_cov_inv=lambda x: x / 0.01).amend(fj)
    lht = nt.Gaussian(torch.from_numpy(data), noise_cov_inv=lambda x: x / 0.01).amend(ft)
    want = jax.jit(lhj.metric)(jt(pos), jt(tan))
    got = lht.metric(pt, nt.position_from_numpy(ft, tan))
    for k in pos:
        for g, w in (zip(got[k], want[k]) if isinstance(got[k], list) else [(got[k], want[k])]):
            _close(g.numpy(), w)


@pytest.mark.parametrize("learned", [False, True])
def test_icr_field_matches_jax(learned):
    """``ICRField`` with a fixed covariance and with a learned Matérn one and
    a normal offset: the forward and the metric (the Matérn matrices
    rebuilt under jvp and vjp)."""
    gj = jm.SimpleOpenGrid(shape0=(6, 6), depth=2, padding=1)
    gt = tm.SimpleOpenGrid(shape0=(6, 6), depth=2, padding=1)
    if learned:
        fj = jm.ICRField(gj, _matern(jm), offset=(0.1, 0.2))
        ft = tm.ICRField(gt, _matern(tm), offset=(0.1, 0.2), **F64)
    else:
        fj = jm.ICRField(gj, lambda r: jnp.exp(-r / 2.0))
        ft = tm.ICRField(gt, lambda r: torch.exp(-r / 2.0), **F64)
    assert sorted(ft.domain) == sorted(fj.domain)
    pos = _numpy_position(fj.init(jax.random.PRNGKey(2)))
    _close(ft(nt.position_from_numpy(ft, pos)).numpy(), jax.jit(fj)(
        {k: [jnp.asarray(u) for u in v] if isinstance(v, list) else jnp.asarray(v)
         for k, v in pos.items()}))
    _metric_matches(fj, ft, pos, 3)


def test_icr_field_vmap_and_interop():
    """A batch of positions under ``torch.func.vmap`` against a loop, the
    per-level excitations handed over as a tuple too."""
    gt = tm.SimpleOpenGrid(shape0=(6, 6), depth=2, padding=1)
    ft = tm.ICRField(gt, _matern(tm), **F64)
    rng = np.random.default_rng(4)
    batch = {k: [rng.standard_normal((3,) + s.shape) for s in v] if isinstance(v, list)
             else rng.standard_normal((3,) + v.shape) for k, v in ft.domain.items()}
    pb = nt.position_from_numpy(ft, batch, batch=(3,))
    out = torch.func.vmap(ft)(pb)
    for i in range(3):
        one = {k: tuple(u[i] for u in v) if isinstance(v, list) else v[i] for k, v in batch.items()}
        _close(out[i].numpy(), ft(nt.position_from_numpy(ft, one)).numpy(), 1e-12)
    with pytest.raises(ValueError, match="arrays expected"):
        nt.position_from_numpy(ft, {k: v[:1] if isinstance(v, list) else v
                                    for k, v in batch.items()}, batch=(3,))


@pytest.mark.parametrize("learned", [False, True])
def test_healpix_icr_field_matches_jax(native_healpix, learned):
    gj = jm.HEALPixRefinementGrid(nside0=1, depth=2)
    gt = tm.HEALPixRefinementGrid(nside0=1, depth=2)
    if learned:
        args = dict(ndim=3, r_min=0.01, r_max=2.0, scale=(1.0, 0.3), cutoff=(3.0, 0.5),
                    loglogslope=(-4.0, 0.5), n_integrate=300, n_interpolate=64)
        fj, ft = jm.HEALPixICRField(gj, jm.MaternCovarianceModel(**args)), tm.HEALPixICRField(
            gt, tm.MaternCovarianceModel(**args), **F64)
    else:
        fj = jm.HEALPixICRField(gj, lambda r: jnp.exp(-r / 0.5))
        ft = tm.HEALPixICRField(gt, lambda r: torch.exp(-r / 0.5), **F64)
    pos = _numpy_position(fj.init(jax.random.PRNGKey(5)))
    jpos = {k: [jnp.asarray(u) for u in v] if isinstance(v, list) else jnp.asarray(v)
            for k, v in pos.items()}
    _close(ft(nt.position_from_numpy(ft, pos)).numpy(), jax.jit(fj.__call__)(jpos))
    if learned:
        _metric_matches(nj.Model(fj.__call__, domain=fj.domain), ft, pos, 6)


@pytest.mark.parametrize("linthresh", [None, 3.0])
def test_sphere_radius_icr_field_matches_jax(native_healpix, linthresh):
    kw = dict(nside0=1, n_r0=6, r_min=1.0, r_max=10.0, depth=2, r_linthresh=linthresh)
    gj, gt = jm.SphereLogRadiusGrid(**kw), tm.SphereLogRadiusGrid(**kw)
    assert gt.shapes == gj.shapes
    fj = jm.SphereRadiusICRField(gj, lambda r: jnp.exp(-r / 2.0))
    ft = tm.SphereRadiusICRField(gt, lambda r: torch.exp(-r / 2.0), **F64)
    xs = _levels(gj.shapes, 7)
    _close(ft({"srfexcitations": [torch.from_numpy(x) for x in xs]}).numpy(),
           jax.jit(fj.__call__)({"srfexcitations": [jnp.asarray(x) for x in xs]}))


def test_icr_fields_build_on_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tm.ICRField(tm.SimpleOpenGrid(shape0=(6,), depth=1), partial(torch.exp))
