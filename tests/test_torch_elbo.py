"""Port parity: Lanczos, the evidence lower bound and the Wiener filter.

Both packages get the same numpy-made models, samples and start vectors
(the JAX package draws its Lanczos start vectors and Rademacher probes
from jax keys; the tests make the same draws and hand them to the port).
Float64 on the CPU.  Tolerances, and why:

- the Lanczos tridiagonal matrix and basis, the SLQ log-determinant, the
  ELBO's eigenvalues, per-sample values and stats: 1e-10 relative (the
  same recurrence with full reorthogonalisation; only summation orders
  differ);
- against dense linear algebra (``eigh``, the analytic log evidence): the
  bounds of ``tests/test_elbo.py``;
- the Wiener filter's mean and samples: 1e-10 and 1e-8 (a converged CG
  solve, then the samplers' CG, as ``tests/test_torch_vi.py``).
"""

import numpy as np
import pytest
import torch
from jax import numpy as jnp
from jax import random

import nifty_tpu as nj
import nifty_tpu_torch as nt
from nifty_tpu.evidence_lower_bound import _eigsh_lanczos as jax_eigsh_lanczos
from nifty_tpu.evidence_lower_bound import _ravel_metric as jax_ravel_metric
from nifty_tpu.evidence_lower_bound import estimate_evidence_lower_bound as jax_elbo
from nifty_tpu.likelihood import StandardHamiltonian as JaxHamiltonian
from nifty_tpu.num.lanczos import lanczos_tridiag as jax_lanczos_tridiag
from nifty_tpu.num.lanczos import stochastic_lq_logdet as jax_slq
from nifty_tpu.utils.tree import random_like as jax_random_like
from nifty_tpu_torch.evidence_lower_bound import _eigsh_lanczos, _ravel_metric

torch.set_num_threads(1)


def _close(a, b, rtol):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    np.testing.assert_allclose(a, b, rtol=rtol, atol=rtol * max(np.abs(b).max(), 1e-300))


def _rand_spd(seed, n, cond=30.0):
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    return (q * np.logspace(0, np.log10(cond), n)) @ q.T


# --- Lanczos ---------------------------------------------------------------------


@pytest.mark.parametrize("order", [1, 2, 12, 40])
def test_lanczos_tridiag_matches_jax(order):
    """T and the Krylov basis from the same start vector; at full order the
    spectrum and an orthonormal basis (``tests/test_elbo.py:22-34``)."""
    m = _rand_spd(0, 40)
    v0 = np.random.default_rng(1).standard_normal(40)
    tj, vj = jax_lanczos_tridiag(lambda x: jnp.asarray(m) @ x, jnp.asarray(v0), order=order)
    mt = torch.from_numpy(m)
    tt, vt = nt.lanczos_tridiag(lambda x: mt @ x, torch.from_numpy(v0), order=order)
    _close(tt.numpy(), tj, 1e-10)
    _close(vt.numpy(), vj, 1e-10)
    if order == 40:
        np.testing.assert_allclose(np.sort(np.linalg.eigvalsh(tt.numpy())),
                                   np.sort(np.linalg.eigvalsh(m)), rtol=1e-8)
        np.testing.assert_allclose(vt.numpy() @ vt.numpy().T, np.eye(40), atol=1e-8)


def test_stochastic_lq_logdet_matches_jax():
    """The SLQ estimate from the JAX package's Rademacher probes, handed
    in; from a generator, within 10 % of ``slogdet`` as in
    ``tests/test_elbo.py:37-43``."""
    n = 60
    m = _rand_spd(2, n, cond=10.0)
    key = random.PRNGKey(3)
    want = float(jax_slq(jnp.asarray(m), order=25, n_samples=30, key=key))
    probes = np.stack([np.asarray(random.rademacher(k, (n,), dtype=jnp.float64))
                       for k in random.split(key, 30)])
    got = nt.stochastic_lq_logdet(torch.from_numpy(m), 25, 30, probes=probes)
    _close(float(got), want, 1e-10)
    mt = torch.from_numpy(m)
    est = float(nt.stochastic_lq_logdet(lambda x: mt @ x, 25, 30, torch.Generator().manual_seed(0),
                                        shape0=n))
    ref = float(np.linalg.slogdet(m)[1])
    assert abs(est - ref) / abs(ref) < 0.1


# --- the ELBO --------------------------------------------------------------------


def _jax_starts(key, n, size):
    """The start vectors the JAX package's ELBO draws, batch after batch."""
    out = []
    for _ in range(n):
        key, sk = random.split(key)
        out.append(np.asarray(random.normal(sk, (size,), dtype=jnp.float64)))
    return np.stack(out)


def _linear_model(n_dat, n_par, seed, noise_std=0.3, data=None):
    """``d = A ξ + n`` in both packages, positions as ``{"xi": ...}``."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n_dat, n_par)) / np.sqrt(n_par)
    if data is None:
        data = a @ rng.standard_normal(n_par) + noise_std * rng.standard_normal(n_dat)
    aj, at = jnp.asarray(a), torch.from_numpy(a)
    lhj = nj.Gaussian(jnp.asarray(data), noise_cov_inv=lambda x: x / noise_std**2).amend(
        lambda x: aj @ x["xi"], domain={"xi": jnp.zeros((n_par,))})
    fwd = nt.Model(lambda x: at @ x["xi"], domain={"xi": nt.ShapeWithDtype((n_par,))})
    lht = nt.Gaussian(torch.from_numpy(data), noise_cov_inv=lambda x: x / noise_std**2).amend(fwd)
    return lhj, lht, a, data


def test_elbo_eigenvalues_match_dense_and_jax():
    """The 12 eigenvalues of M = AᵀA + 1 above one, by 4 batches of
    deflated Lanczos, against the JAX package from the same start vectors
    and against ``eigh`` (``tests/test_elbo.py:115-138``)."""
    n_dat, n_par = 12, 30
    lhj, lht, a, _ = _linear_model(n_dat, n_par, 5, noise_std=1.0, data=np.zeros(12))
    posj = {"xi": jnp.zeros(n_par)}
    met_j, size, dtype = jax_ravel_metric(JaxHamiltonian(lhj).metric, posj)
    kw = dict(min_lh_eval=1e-12, n_batches=4, verbose=False, early_stop=False)
    ej, _ = jax_eigsh_lanczos(met_j, size, dtype, n_dat, tot_dofs=n_dat, key=random.PRNGKey(6), **kw)
    met_t, size_t, dtype_t, _ = _ravel_metric(nt.StandardHamiltonian(lht).metric,
                                              {"xi": torch.zeros(n_par, dtype=torch.float64)})
    assert (size_t, dtype_t) == (size, torch.float64)
    et, vt = _eigsh_lanczos(met_t, size, dtype_t, n_dat, tot_dofs=n_dat,
                            start_vectors=_jax_starts(random.PRNGKey(6), 12, size), **kw)
    _close(et, np.asarray(ej), 1e-10)
    ref = np.sort(np.linalg.eigvalsh(a.T @ a + np.eye(n_par)))[::-1][:n_dat]
    np.testing.assert_allclose(et, ref, rtol=1e-6)
    m = a.T @ a + np.eye(n_par)
    for lam, v in zip(et, vt.numpy()):  # Ritz pairs: M v = λ v
        assert np.linalg.norm(m @ v - lam * v) <= 1e-6 * lam


@pytest.mark.parametrize("n_dat,n_par", [(10, 25), (25, 10)])
def test_elbo_linear_gaussian_matches_jax(n_dat, n_par):
    """The ELBO of the exact posterior of d = A ξ + n from 3000 exact
    posterior samples: per-sample values and stats against the JAX package
    (same start vectors), and the mean against the analytic log evidence
    (``tests/test_elbo.py:46-112``)."""
    noise_std = 0.3
    lhj, lht, a, data = _linear_model(n_dat, n_par, 42, noise_std)
    m_mat = a.T @ a / noise_std**2 + np.eye(n_par)
    cov = np.linalg.inv(m_mat)
    mean = cov @ (a.T @ data / noise_std**2)
    smpls = (np.linalg.cholesky(cov) @ np.random.default_rng(7).standard_normal((n_par, 3000))).T
    n_eig = min(n_dat, n_par)
    sj = nj.Samples(pos={"xi": jnp.asarray(mean)}, samples={"xi": jnp.asarray(smpls)})
    ej, stj = jax_elbo(lhj, sj, n_eig, key=random.PRNGKey(42), min_lh_eval=1e-10, verbose=False)
    st = nt.Samples(pos={"xi": torch.from_numpy(mean)}, samples={"xi": torch.from_numpy(smpls)})
    et, stt = nt.estimate_evidence_lower_bound(
        lht, st, n_eig, start_vectors=_jax_starts(random.PRNGKey(42), n_eig, n_par),
        min_lh_eval=1e-10, verbose=False)
    _close(et, np.asarray(ej), 1e-10)
    for k in ("elbo_mean", "elbo_up", "elbo_lw", "lower_error"):
        _close(stt[k], stj[k], 1e-10)
    s_d = a @ a.T + noise_std**2 * np.eye(n_dat)
    log_ev = -0.5 * (data @ np.linalg.solve(s_d, data) + np.linalg.slogdet(s_d)[1]
                     + n_dat * np.log(2 * np.pi))
    log_norm = -0.5 * (n_dat * np.log(2 * np.pi) + n_dat * np.log(noise_std**2))
    assert abs(stt["elbo_mean"] + log_norm - log_ev) < 0.1 * abs(log_ev) + 0.5


def test_elbo_saves_and_resumes_its_eigensystem(tmp_path):
    """With ``output_directory`` the eigensystem goes to
    ``<prefix>_eigsys.npz``; the next call reads it back and computes no
    new eigenpair; resuming from part of it finds the rest."""
    lhj, lht, a, data = _linear_model(8, 20, 3)
    pos = {"xi": torch.zeros(20, dtype=torch.float64)}
    st = nt.Samples(pos=pos, samples={"xi": torch.from_numpy(
        np.random.default_rng(1).standard_normal((4, 20)))})
    kw = dict(min_lh_eval=1e-12, n_batches=2, verbose=False)
    e1, s1 = nt.estimate_evidence_lower_bound(lht, st, 8, key=torch.Generator().manual_seed(0),
                                              output_directory=str(tmp_path), **kw)
    with np.load(tmp_path / "metric_eigsys.npz") as f:
        assert f["eigenvalues"].shape == (8,) and f["eigenvectors"].shape == (8, 20)
        evals, evecs = f["eigenvalues"], f["eigenvectors"]
    never = torch.Generator().manual_seed(1)
    e2, s2 = nt.estimate_evidence_lower_bound(lht, st, 8, key=never, output_directory=str(tmp_path), **kw)
    assert never.get_state().equal(torch.Generator().manual_seed(1).get_state())  # no new batch
    _close(e2, e1, 1e-14)
    e3, s3 = nt.estimate_evidence_lower_bound(lht, st, 8, key=torch.Generator().manual_seed(2),
                                              resume_eigenvalues=evals[:4],
                                              resume_eigenvectors=evecs[:4], **kw)
    ref = np.sort(np.linalg.eigvalsh(a.T @ a / 0.3**2 + np.eye(20)))[::-1][:8]
    np.testing.assert_allclose(np.sort(evals)[::-1], ref, rtol=1e-6)
    _close(s3["elbo_mean"], s1["elbo_mean"], 1e-8)


# --- the Wiener filter -------------------------------------------------------------


def _wiener_pair(nonlinear=False, n=6, m=8, seed=0):
    """``tests/test_evi.py``'s linear-Gaussian model (or its exp) in both
    packages."""
    rng = np.random.default_rng(seed)
    R = rng.normal(size=(m, n))
    ncov_inv = np.linalg.inv(np.diag(rng.uniform(0.5, 2.0, size=m)))
    data = rng.normal(size=m)
    Rj, Nj, Rt, Nt = jnp.asarray(R), jnp.asarray(ncov_inv), torch.from_numpy(R), torch.from_numpy(ncov_inv)
    outer_j, outer_t = (jnp.exp, torch.exp) if nonlinear else (lambda x: x, lambda x: x)
    fj = nj.Model(lambda x: outer_j(0.3 * (Rj @ x["xi"])), domain={"xi": nj.ShapeWithDtype((n,))},
                  white_init=True)
    lhj = nj.Gaussian(jnp.asarray(data), noise_cov_inv=lambda x: Nj @ x).amend(fj)
    ft = nt.Model(lambda x: outer_t(0.3 * (Rt @ x["xi"])), domain={"xi": nt.ShapeWithDtype((n,))})
    lht = nt.Gaussian(torch.from_numpy(data), noise_cov_inv=lambda x: Nt @ x).amend(ft)
    post_cov = np.linalg.inv(0.09 * R.T @ ncov_inv @ R + np.eye(n))
    return lhj, lht, post_cov, 0.3 * R, ncov_inv, data


@pytest.mark.parametrize("residual_map", ["vmap", "lmap"])
def test_wiener_filter_posterior_matches_jax(residual_map):
    """The posterior mean (host CG to 1e-12) against the JAX package's and
    the analytic one, and two mirrored sample pairs drawn around it from
    the JAX package's draws, under either map."""
    lhj, lht, post_cov, R, ncov_inv, data = _wiener_pair()
    pj, pt = {"xi": jnp.zeros(6)}, {"xi": torch.zeros(6, dtype=torch.float64)}
    key = random.PRNGKey(0)
    kw = dict(cg_kwargs=dict(resnorm=1e-12, maxiter=200))
    sj, (ij, sij) = nj.wiener_filter_posterior(lhj, pj, key=key, n_samples=2, draw_linear_kwargs=kw)
    whites = []
    for k in random.split(key, 2):  # the draws of draw_linear_residual(lhj, mean, k)
        k_nll, k_prr = random.split(k, 2)
        whites.append(nt.WhiteNoise(
            torch.from_numpy(np.array(jax_random_like(k_nll, lhj.left_sqrt_metric_tangents_shape))),
            {"xi": torch.from_numpy(np.array(jax_random_like(k_prr, sj.pos)["xi"]))}))
    st, (it, sit) = nt.wiener_filter_posterior(
        lht, pt, n_samples=2, residual_map=residual_map,
        draw_linear_kwargs=dict(kw, white=nt.stack(whites)))
    assert int(it) == int(ij) == 0 and len(st) == len(sj) == 4
    _close(st.pos["xi"].numpy(), sj.pos["xi"], 1e-10)
    _close(st.pos["xi"].numpy(), post_cov @ R.T @ ncov_inv @ data, 1e-8)
    _close(st._samples["xi"].numpy(), sj._samples["xi"], 1e-8)
    assert np.asarray(sit).tolist() == np.asarray(sij).tolist()


def test_wiener_filter_linearised_model_matches_jax():
    """``model_is_linear=False``: the Wiener filter of the model linearised
    at a position, against the JAX package; a key draws the samples."""
    lhj, lht, *_ = _wiener_pair(nonlinear=True)
    p0 = 0.2 * np.random.default_rng(3).standard_normal(6)
    kw = dict(cg_kwargs=dict(resnorm=1e-12, maxiter=200))
    sj, _ = nj.wiener_filter_posterior(lhj, {"xi": jnp.asarray(p0)}, model_is_linear=False,
                                       draw_linear_kwargs=kw)
    st, _ = nt.wiener_filter_posterior(lht, {"xi": torch.from_numpy(p0)}, model_is_linear=False,
                                       draw_linear_kwargs=kw)
    _close(st.pos["xi"].numpy(), sj.pos["xi"], 1e-10)
    st2, (_, infos) = nt.wiener_filter_posterior(
        lht, {"xi": torch.from_numpy(p0)}, key=torch.Generator().manual_seed(4), n_samples=3,
        draw_linear_kwargs=kw, model_is_linear=False)
    assert len(st2) == 6 and len(st2.keys) == 3 and infos.shape == (3,)
    _close(st2.pos["xi"].numpy(), sj.pos["xi"], 1e-10)
    with pytest.raises(TypeError):
        nt.wiener_filter_posterior(lht.likelihood, {"xi": torch.from_numpy(p0)})
