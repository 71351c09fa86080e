"""Port parity: the adaptive NUTS sampler (``nifty_tpu_torch/mcmc.py``).

The window adaptation's pieces (dual averaging, Welford, the window
schedule) against the JAX package's on the same numbers: the schedule
exactly, the float64 recurrences to 1e-12.  The sampler itself draws from
torch generators, so it is held to the JAX package's own statistical
tests (``tests/test_hmc.py``): the same settings and tolerances.
"""

import numpy as np
import pytest
import torch
from jax import numpy as jnp

import nifty_tpu.mcmc as mj
import nifty_tpu_torch as nt
from nifty_tpu_torch import mcmc as mt

torch.set_num_threads(1)


def _close(got, want, tol=1e-12):
    got, want = np.asarray(got, dtype=np.float64), np.asarray(want, dtype=np.float64)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


@pytest.mark.parametrize("n_warmup", [0, 7, 19, 20, 33, 100, 150, 151, 200, 500, 1000, 1777])
def test_window_schedule_matches_jax(n_warmup):
    np.testing.assert_array_equal(mt._window_schedule(n_warmup), mj._window_schedule(n_warmup))
    kw = dict(init_buffer=10, term_buffer=20, first_window=5)
    np.testing.assert_array_equal(mt._window_schedule(n_warmup, **kw),
                                  mj._window_schedule(n_warmup, **kw))


def test_dual_averaging_matches_jax():
    """Thirty updates of three chains' step sizes from random acceptance
    probabilities, a restart at the averaged step in between, and the
    keywords of the update."""
    rng = np.random.default_rng(0)
    steps = np.array([0.5, 0.05, 2.0])
    accs = rng.uniform(0.0, 1.0, (30, 3))
    st_t = mt._da_init(torch.from_numpy(steps))
    st_j = [mj._da_init(jnp.asarray(s)) for s in steps]
    for i, a in enumerate(accs):
        kw = dict(target=0.65, gamma=0.1, t0=5.0, kappa=0.6) if i % 3 else {}
        st_t = mt._da_update(st_t, torch.from_numpy(a), **kw)
        st_j = [mj._da_update(s, a_c, **kw) for s, a_c in zip(st_j, a)]
        if i == 14:
            st_t = mt._da_init(torch.exp(st_t.log_step_avg))
            st_j = [mj._da_init(jnp.exp(s.log_step_avg)) for s in st_j]
        for f in st_t._fields:
            _close(getattr(st_t, f).numpy(), [float(getattr(s, f)) for s in st_j])


def test_welford_matches_jax():
    """Welford over a forest of two chains, its variance with and without
    Stan's shrinkage, and a restart."""
    rng = np.random.default_rng(1)
    xs = [{"a": rng.standard_normal((2, 3)), "b": rng.standard_normal((2,))} for _ in range(12)]
    domain = {"a": nt.ShapeWithDtype((3,), torch.float64), "b": nt.ShapeWithDtype((), torch.float64)}
    to_t = lambda x: nt.position_from_numpy(domain, x, device="cpu", batch=(2,))  # noqa: E731
    w_t = mt._welford_init(to_t(xs[0]))
    w_j = [mj._welford_init({k: jnp.asarray(v[c]) for k, v in xs[0].items()}) for c in range(2)]
    for i, x in enumerate(xs):
        if i == 7:
            w_t = mt._welford_init(to_t(x))
            w_j = [mj._welford_init({k: jnp.asarray(v[c]) for k, v in x.items()}) for c in range(2)]
        w_t = mt._welford_update(w_t, to_t(x))
        w_j = [mj._welford_update(w, {k: jnp.asarray(v[c]) for k, v in x.items()})
               for c, w in enumerate(w_j)]
        for c in range(2):
            assert float(w_t.count) == float(w_j[c].count)
            for k in ("a", "b"):
                _close(w_t.mean[k][c].numpy(), w_j[c].mean[k])
                _close(w_t.m2[k][c].numpy(), w_j[c].m2[k])
        for reg in (True, False):
            v_t = mt._welford_variance(w_t, regularize=reg)
            for c in range(2):
                v_j = mj._welford_variance(w_j[c], regularize=reg)
                for k in ("a", "b"):
                    _close(v_t[k][c].numpy(), v_j[k])


def test_get_sample_size_estimate_matches_jax():
    rng = np.random.default_rng(2)
    x = np.cumsum(rng.standard_normal((200, 3)), axis=0) * 0.1 + rng.standard_normal((200, 3))
    tree = {"x": x, "y": rng.standard_normal((4, 50))}
    got = nt.get_sample_size_estimate({k: torch.from_numpy(v) for k, v in tree.items()})
    want = mj.get_sample_size_estimate({"x": jnp.asarray(x)})
    _close(got["x"].numpy(), want["x"], tol=1e-10)
    want_y = mj.get_sample_size_estimate(jnp.asarray(tree["y"]), axis=1)
    _close(nt.get_sample_size_estimate(torch.from_numpy(tree["y"]), axis=1).numpy(), want_y,
           tol=1e-10)


def test_nuts_sample_std_normal_moments():
    """The adaptive sampler on a 2-D standard normal with the settings and
    tolerances of ``tests/test_hmc.py``'s adaptive test (2 chains, 1500
    samples after 500 warm-up steps, depth 8): the chains as one batch."""
    samples, info = nt.nuts_sample(
        lambda q: -0.5 * torch.sum(q**2), 4, n_chains=2, n_samples=1500, n_warmup=500,
        position_proto=torch.zeros(2, dtype=torch.float64), max_tree_depth=8)
    smpl = samples.samples.numpy()
    assert smpl.shape == (2 * 1500, 2)
    np.testing.assert_allclose(smpl.std(axis=0), 1.0, rtol=0.25)
    np.testing.assert_allclose(smpl.mean(axis=0), 0.0, atol=0.15)
    assert np.all(info["acceptance"].numpy() > 0.5)
    assert info["chain_samples"].shape == (2, 1500, 2)
    assert info["tree_depths"].shape == info["leapfrog_steps"].shape == (2, 1500)
    assert info["transition_seconds"].shape == (2, 2000)
    assert info["inverse_mass_matrix"].shape == info["step_size"].shape + (2,)


def test_nuts_sample_maps_give_the_same_chains():
    """``"lmap"`` (a chain at a time), ``"vmap"`` (the batch) and ``"pmap"``
    (a block of chains a rank; here one process holds them all) draw each
    chain from its own generator: the same samples and diagnostics."""
    kw = dict(n_chains=3, n_samples=6, n_warmup=30, max_tree_depth=5,
              position_proto={"a": torch.zeros(2, dtype=torch.float64),
                              "b": torch.zeros((), dtype=torch.float64)})
    logd = lambda q: -0.5 * (torch.sum(q["a"] ** 2 / 4.0) + q["b"] ** 2)  # noqa: E731
    sv, iv = nt.nuts_sample(logd, torch.Generator().manual_seed(7), **kw)
    sl, il = nt.nuts_sample(logd, torch.Generator().manual_seed(7), chain_map="lmap", **kw)
    for k in ("a", "b"):
        np.testing.assert_allclose(sv.samples[k].numpy(), sl.samples[k].numpy(), rtol=1e-12, atol=1e-12)
    for k in ("step_size", "acceptance", "tree_depths", "divergences"):
        np.testing.assert_allclose(iv[k].numpy(), il[k].numpy(), rtol=1e-12)
    assert sv.samples["a"].shape == (18, 2)
    sp, ip = nt.nuts_sample(logd, torch.Generator().manual_seed(7), chain_map="pmap", **kw)
    for k in ("a", "b"):
        np.testing.assert_array_equal(sp.samples[k].numpy(), sv.samples[k].numpy())
    for k in ("step_size", "acceptance", "tree_depths", "divergences", "leapfrog_steps"):
        np.testing.assert_array_equal(ip[k].numpy(), iv[k].numpy())
