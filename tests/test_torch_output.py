"""Port parity: ``optimize_kl``'s hooks and outputs, ``io``, ``plot`` and
``OptimizeKLConfig``.

Float64 on the CPU, the same numpy inputs in both packages.  The port's
samplers are handed the JAX package's own white noise through
``OptimizeVI``'s sampler hooks (a counting hook maps the port's seeds, in
the order they are drawn, to the JAX package's keys), so the two runs
draw the same samples.  Tolerances, and why:

- the VI runs (samples, position, exported means and standard
  deviations): 1e-8 relative to each leaf's largest entry, as the VI
  tests of ``test_torch_vi.py`` (a few CG and Newton steps amplify double
  rounding by a few orders);
- HDF5 exports, the Mollweide grid and the sRGB cube: 1e-10 (the same
  numpy arithmetic);
- ``OptimizeKLConfig``'s schedules: equal.

h5py and matplotlib are taken with ``importorskip``.
"""

import os
import pickle

import jax
import numpy as np
import pytest
import torch
from jax import numpy as jnp
from jax import random

import nifty_tpu as nj
import nifty_tpu_torch as nt
from nifty_tpu.utils.tree import random_like as jax_random_like
import nifty_tpu.io as jax_io  # noqa: E402  (nifty_tpu does not import it)
from nifty_tpu_torch import io

torch.set_num_threads(1)
RTOL = 1e-8


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


# --- 10. optimize_kl: hooks, kl_reduce, outputs ----------------------------------------


N = 32
NOISE_COV = 0.01


def _pair(seed=0):
    """A 1-D correlated field (nonlinear in its hyperparameters) and a
    Gaussian likelihood in both packages, on the same data, and a starting
    latent (numpy).  Not under exp: there the two packages' Newton-CG
    iterates part at ~1e-4 within three KL steps (its line search from an
    energy of ~4e4), which would hide what the hooks do."""
    cfms = nj.CorrelatedFieldMaker("cf"), nt.CorrelatedFieldMaker("cf")
    for cfm in cfms:
        cfm.set_amplitude_total_offset(0.0, (1e-1, 3e-2))
        cfm.add_fluctuations((N,), 1.0 / N, (1.0, 0.5), (-3.0, 0.2))
    cfj, cft = cfms[0].finalize(), cfms[1].finalize(device="cpu", dtype=torch.float64)
    rng = np.random.default_rng(seed)
    draw = lambda s: {k: s * rng.standard_normal(v.shape) for k, v in sorted(cft.domain.items())}  # noqa: E731
    sig_t, sig_j = cft, cfj
    with torch.no_grad():
        truth = sig_t(nt.position_from_numpy(cft, draw(1.0))).numpy()
    data = truth + np.sqrt(NOISE_COV) * rng.standard_normal(N)
    lhj = nj.Gaussian(jnp.asarray(data), noise_cov_inv=lambda x: x / NOISE_COV).amend(sig_j)
    lht = nt.Gaussian(torch.from_numpy(data), noise_cov_inv=lambda x: x / NOISE_COV).amend(sig_t)
    return lhj, lht, sig_j, sig_t, cft, draw(0.1)


def _jax_white(lhj, pj, key):
    """The JAX package's draws inside ``draw_linear_residual(lhj, pj, key)``
    (the key split in two: data-space, then latent draws in sorted key
    order) as the port's WhiteNoise."""
    k_nll, k_prr = random.split(key, 2)
    data = np.array(jax_random_like(k_nll, lhj.left_sqrt_metric_tangents_shape))
    prior = jax_random_like(k_prr, pj)
    keys = sorted(pj)
    return nt.WhiteNoise(torch.from_numpy(data), {
        k: torch.from_numpy(np.array(v)) for k, v in zip(keys, jax.tree_util.tree_leaves(prior))})


class _JaxDraws:
    """The port's sampler hooks, drawing what the JAX package's
    ``optimize_kl`` draws from ``key``: the n-th linear draw takes the
    n-th of the JAX package's sample keys (two splits an iteration), the
    nonlinear update of a pair the key of its linear draw."""

    def __init__(self, lhj, pj, key, n_iterations, n_samples):
        self.lhj, self.pj, self.keys, self.of_seed = lhj, pj, [], {}
        for _ in range(n_iterations):
            key, sk = random.split(key, 2)
            self.keys.extend(random.split(sk, n_samples))
        self.n_linear = self.n_nonlinear = 0

    def linear(self, lh, pos, seed, **kwargs):
        self.of_seed[seed] = self.keys[self.n_linear]
        self.n_linear += 1
        return nt.draw_linear_residual(lh, pos, white=_jax_white(self.lhj, self.pj, self.of_seed[seed]),
                                       **kwargs)

    def nonlinear(self, lh, pos, residual, seed, sign, **kwargs):
        self.n_nonlinear += 1
        return nt.nonlinearly_update_residual(
            lh, pos, residual, white=_jax_white(self.lhj, self.pj, self.of_seed[seed]),
            metric_sample_sign=sign, **kwargs)


CG = dict(maxiter=5, miniter=5, resnorm=-1.0)
VI_KW = dict(
    n_total_iterations=2,
    n_samples=2,
    sample_mode="linear_resample",
    draw_linear_kwargs=dict(cg_kwargs=CG),
    nonlinearly_update_kwargs=dict(minimize_kwargs=dict(maxiter=2, xtol=-1.0, cg_kwargs=CG)),
    kl_kwargs=dict(minimize_kwargs=dict(maxiter=2, xtol=-1.0, cg_kwargs=CG)),
)


def _runs(tmp_path, draws, **kw):
    """The JAX package's ``optimize_kl`` and the port's, the port's
    ``OptimizeVI`` given the hooks in ``kw``; both with ``odir`` in
    ``tmp_path`` and the signal exported."""
    lhj, lht, sig_j, sig_t, cft, start = _pair()
    pj = nj.Vector({k: jnp.asarray(v) for k, v in start.items()})
    vi_kw = {k: v for k, v in kw.items() if k in VI_KW}
    hooks = {k: v for k, v in kw.items() if k not in VI_KW}
    jax_reduce = hooks.pop("jax_kl_reduce", None)
    run_kw = dict(VI_KW, **vi_kw)
    key = random.PRNGKey(7)
    sj, _ = nj.optimize_kl(lhj, pj, key=key, odir=str(tmp_path / "jax"),
                           export_operators={"signal": sig_j},
                           **({} if jax_reduce is None else dict(kl_reduce=jax_reduce)), **run_kw)
    draws = draws(lhj, dict(pj.tree), key, run_kw["n_total_iterations"], run_kw["n_samples"])
    opt = nt.OptimizeVI(lht, run_kw["n_total_iterations"], _draw_linear_residual=draws.linear,
                        _nonlinearly_update_residual=draws.nonlinear, **hooks)
    st, state = nt.optimize_kl(lht, nt.position_from_numpy(cft, start),
                               key=torch.Generator().manual_seed(0), _optimize_vi=opt,
                               odir=str(tmp_path / "port"), export_operators={"signal": sig_t},
                               **run_kw)
    return sj, st, state, draws


def test_optimize_kl_hooks_and_kl_reduce_match_jax(tmp_path):
    """Two MGVI iterations of 2 sample pairs with the median over the
    samples as ``kl_reduce`` in both packages; the port's sampler is a hook
    fed the JAX package's draws, and its status message a counting hook.
    The samples, the position and the exported posterior mean and standard
    deviation of the signal agree; the history plots are written."""
    pytest.importorskip("matplotlib")
    messages = []

    def status(samples, state, name=""):
        messages.append(state.nit)
        return f"{name}: iteration {state.nit}"

    sj, st, state, draws = _runs(
        tmp_path, _JaxDraws, _get_status_message=status,
        kl_reduce=lambda t: nt.utils.tree.tree_map(lambda x: torch.quantile(x, 0.5, dim=0), t),
        jax_kl_reduce=lambda t: jax.tree_util.tree_map(lambda x: jnp.median(x, axis=0), t))
    assert (draws.n_linear, draws.n_nonlinear, messages) == (4, 0, [1, 2])
    assert state.nit == 2 and len(st) == 4
    _close_tree(st.pos, sj.pos)
    _close_tree(st._samples, sj._samples)
    odir = tmp_path / "port"
    got, want = (np.load(d / "operator_outputs" / "signal_last.npz") for d in (odir, tmp_path / "jax"))
    for k in ("mean", "std"):
        _close(got[k], want[k])
    assert int(got["nit"]) == int(want["nit"]) == 2
    for name in ("energy_history.png", "minisanity_history.png", "minisanity_prior_history.png",
                 "minisanity.txt"):
        assert (odir / name).stat().st_size > 0, name
    assert "iteration 2" in (odir / "minisanity.txt").read_text()


def test_optimize_kl_nonlinear_hook_matches_jax(tmp_path):
    """One geoVI iteration of 2 sample pairs, both sampler hooks fed the JAX
    package's draws: the curved samples within 1e-8, the position after
    the KL step within 1e-6 (its two Newton steps from the curved samples
    amplify their ~8e-10 difference about fifty-fold, to ~4.5e-8)."""
    sj, st, state, draws = _runs(tmp_path, _JaxDraws, n_total_iterations=1,
                                 sample_mode="nonlinear_resample")
    assert (draws.n_linear, draws.n_nonlinear) == (2, 4)
    assert len(state.sample_state) == 4 and all(int(s.nit) == 2 for s in state.sample_state)
    _close_tree(st._samples, sj._samples)
    _close_tree(st.pos, sj.pos, rtol=1e-6)


def test_optimize_kl_given_optimizer_and_state_match_jax():
    """``_optimize_vi`` with counting KL hooks around the defaults and
    ``_optimize_vi_state`` from iteration 1: two MAP iterations (no
    samples) to the JAX package's position."""
    lhj, lht, _, _, cft, start = _pair(seed=1)
    kw = dict(n_total_iterations=3, n_samples=0,
              kl_kwargs=dict(minimize_kwargs=dict(maxiter=3, xtol=-1.0, cg_kwargs=CG)))
    opt_j = nj.OptimizeVI(lhj, 3)
    sj, _ = nj.optimize_kl(lhj, nj.Vector({k: jnp.asarray(v) for k, v in start.items()}),
                           key=random.PRNGKey(0), _optimize_vi=opt_j,
                           _optimize_vi_state=opt_j.init_state(random.PRNGKey(0), nit=1, n_samples=0,
                                                               kl_kwargs=kw["kl_kwargs"]), **kw)
    calls = {"vg": 0, "met": 0}
    base = nt.OptimizeVI(lht, 3)

    def vg(primals, primals_samples):
        calls["vg"] += 1
        return base.kl_value_and_grad(primals, primals_samples=primals_samples)

    def met(primals, tangents, primals_samples):
        calls["met"] += 1
        return base.kl_metric(primals, tangents, primals_samples=primals_samples)

    opt = nt.OptimizeVI(lht, 3, _kl_value_and_grad=vg, _kl_metric=met)
    gen = torch.Generator().manual_seed(0)
    st, state = nt.optimize_kl(lht, nt.position_from_numpy(cft, start), key=gen, _optimize_vi=opt,
                               _optimize_vi_state=opt.init_state(gen, nit=1, n_samples=0,
                                                                 kl_kwargs=kw["kl_kwargs"]), **kw)
    assert state.nit == 3 and calls["vg"] > 0 and calls["met"] > 0
    _close_tree(st.pos, sj.pos)


def test_optimize_kl_takes_no_multi_device_arguments():
    """``jit`` is not taken (an eager program compiles nothing); ``devices``
    and ``position_sharding`` are (multi-GPU, tests/test_torch_parallel.py),
    and without them, or None, the run is the one-process one."""
    import inspect

    _, lht, _, _, cft, start = _pair()
    with pytest.raises(TypeError):
        nt.optimize_kl(lht, nt.position_from_numpy(cft, start), key=torch.Generator(),
                       n_total_iterations=1, n_samples=0, jit=False)
    assert {"devices", "position_sharding"} <= set(inspect.signature(nt.optimize_kl).parameters)
    st, state = nt.optimize_kl(lht, nt.position_from_numpy(cft, start), key=torch.Generator(),
                               n_total_iterations=1, n_samples=0, devices=None,
                               position_sharding=None)
    assert state.nit == 1 and len(st) == 0


def test_optimize_kl_checkpoint_loads_and_resumes(tmp_path):
    """``last.pkl`` holds the samples and the state with CPU tensors and the
    generator as its state: ``load_samples`` reads its samples with the
    same bits, and ``resume`` goes on from it to the uninterrupted run."""
    _, lht, _, sig_t, cft, start = _pair(seed=2)
    kw = dict(VI_KW, sample_mode="linear_resample")
    full, _ = nt.optimize_kl(lht, nt.position_from_numpy(cft, start),
                             key=torch.Generator().manual_seed(3), **kw)
    odir = str(tmp_path / "run")
    first, _ = nt.optimize_kl(lht, nt.position_from_numpy(cft, start),
                              key=torch.Generator().manual_seed(3), odir=odir,
                              **dict(kw, n_total_iterations=1))
    with open(os.path.join(odir, "last.pkl"), "rb") as f:
        samples, state = pickle.load(f)
    assert isinstance(state.key, io.GeneratorState) and state.config == {}
    back = nt.io.load_samples(os.path.join(odir, "last.pkl"), device="cpu")
    for k in first.pos:
        assert torch.equal(back.pos[k], first.pos[k]) and torch.equal(back._samples[k], first._samples[k])
    resumed, state = nt.optimize_kl(lht, nt.position_from_numpy(cft, start),
                                    key=torch.Generator().manual_seed(99), odir=odir, resume=True, **kw)
    assert state.nit == 2
    for k in full.pos:
        torch.testing.assert_close(resumed.pos[k], full.pos[k], rtol=1e-12, atol=1e-12)
        torch.testing.assert_close(resumed._samples[k], full._samples[k], rtol=1e-12, atol=1e-12)


# --- 11. io -------------------------------------------------------------------------------


def _samples_pair():
    rng = np.random.default_rng(0)
    pos, res = {"a": np.ones(4), "b": rng.normal(size=(2, 3))}, {"a": rng.normal(size=(3, 4)),
                                                                  "b": rng.normal(size=(3, 2, 3))}
    sj = nj.Samples(pos={k: jnp.asarray(v) for k, v in pos.items()},
                    samples={k: jnp.asarray(v) for k, v in res.items()})
    st = nt.Samples(pos={k: torch.from_numpy(v) for k, v in pos.items()},
                    samples={k: torch.from_numpy(v) for k, v in res.items()}, keys=[5])
    return sj, st


def test_save_and_load_samples(tmp_path):
    """A pickle round trip to the CPU; a generator pickles as its state and
    comes back with the same stream."""
    _, st = _samples_pair()
    fn = str(tmp_path / "sub" / "s.pkl")
    nt.io.save_samples(st, fn)
    assert not os.path.exists(fn + ".tmp")
    back = nt.io.load_samples(fn, device="cpu")
    assert back.keys == [5]
    for k in st.pos:
        assert torch.equal(back.samples[k], st.samples[k])
    g = torch.Generator().manual_seed(11)
    g2 = io.to_device(io.to_cpu({"g": g}), "cpu")["g"]
    assert torch.equal(torch.randn(4, generator=g2), torch.randn(4, generator=g))
    with open(str(tmp_path / "x.pkl"), "wb") as f:
        pickle.dump({"not": "samples"}, f)
    with pytest.raises(TypeError, match="Samples"):
        nt.io.load_samples(str(tmp_path / "x.pkl"), device="cpu")


def test_samples_to_hdf5_matches_jax(tmp_path):
    h5py = pytest.importorskip("h5py")
    sj, st = _samples_pair()
    ops_j = {"sq": lambda s: {"a": s["a"] ** 2, "b": jnp.sin(s["b"])}}
    ops_t = {"sq": lambda s: {"a": s["a"] ** 2, "b": torch.sin(s["b"])}}
    jax_io.samples_to_hdf5(sj, str(tmp_path / "j.h5"), operators=ops_j)
    nt.io.samples_to_hdf5(st, str(tmp_path / "t.h5"), operators=ops_t)
    with pytest.raises(FileExistsError):
        nt.io.samples_to_hdf5(st, str(tmp_path / "t.h5"))
    with h5py.File(str(tmp_path / "j.h5")) as fj, h5py.File(str(tmp_path / "t.h5")) as ft:
        assert ft.attrs["n_samples"] == fj.attrs["n_samples"] == 3
        for name in ("latent", "sq"):
            for part in ("samples", "mean", "std"):
                gj, gt = fj[name][part], ft[name][part]
                assert sorted(gt) == sorted(gj) == ["0", "1"]
                for leaf in gj:
                    _close(gt[leaf][()], gj[leaf][()], rtol=1e-10)


# --- 12. plot -------------------------------------------------------------------------------


def test_mollweide_grid_and_rgb_match_jax():
    from nifty_tpu.plot import mollweide_grid_from_healpix as jax_moll
    from nifty_tpu.plot import rgb_from_spectral_cube as jax_rgb

    m = np.arange(12.0 * 4**2)
    g = nt.plot.mollweide_grid_from_healpix(torch.from_numpy(m), xsize=128)
    want = jax_moll(m, xsize=128)
    assert g.shape == (64, 128)
    np.testing.assert_array_equal(np.isnan(g), np.isnan(want))
    np.testing.assert_array_equal(g[np.isfinite(g)], want[np.isfinite(want)])
    cube = np.random.default_rng(0).random((9, 12, 10))
    img = nt.plot.rgb_from_spectral_cube(torch.from_numpy(cube))
    assert img.shape == (12, 10, 3) and 0.0 <= img.min() and img.max() <= 1.0
    _close(img, jax_rgb(cube), rtol=1e-10)
    with pytest.raises(ValueError, match="HEALPix"):
        nt.plot.mollweide_grid_from_healpix(np.ones(13))


def test_plot_panels(tmp_path):
    """``tests/test_aux.py``'s panels, with tensors: a line, an image, a
    HEALPix map, a log-log spectrum, a histogram and a spectral cube."""
    pytest.importorskip("matplotlib")
    rng = np.random.default_rng(0)
    p = nt.plot.Plot()
    p.add(torch.from_numpy(rng.normal(size=100)), title="line")
    p.add(rng.normal(size=(32, 32)), title="image")
    p.add(torch.from_numpy(rng.normal(size=12 * 4**2)), title="healpix")
    p.add((np.geomspace(1, 100, 20), torch.from_numpy(np.geomspace(1, 1e-4, 20))), kind="loglog")
    p.add(rng.normal(size=500), kind="hist", title="hist")
    p.add(rng.random((9, 12, 10)), title="cube")
    fn = str(tmp_path / "out.png")
    p.output(name=fn)
    assert os.path.getsize(fn) > 0
    with pytest.raises(RuntimeError, match="nothing"):
        p.output(name=fn)


# --- 13. OptimizeKLConfig ---------------------------------------------------------------------


CFG = """
[optimization]
output directory = {odir}

[base.opt]
sample mode = linear_resample

[optimization.1]
base = base.opt
total iterations = 3
n samples = 2*2,3

[optimization.02]
base = base.opt
total iterations = 2
n samples = 4
sample mode = nonlinear_update
"""


def test_optimize_kl_config_matches_jax(tmp_path):
    """``tests/test_aux.py``'s config text: the same arguments and
    schedules as the JAX package's parser."""
    from nifty_tpu.config_file import OptimizeKLConfig as JaxConfig

    cfg_file = str(tmp_path / "c.cfg")
    with open(cfg_file, "w") as f:
        f.write(CFG.format(odir=str(tmp_path / "out")))
    got, want = dict(nt.OptimizeKLConfig.from_file(cfg_file)), dict(JaxConfig.from_file(cfg_file))
    assert set(got) == set(want) == {"odir", "n_total_iterations", "n_samples", "sample_mode"}
    assert got["n_total_iterations"] == want["n_total_iterations"] == 5
    for key in ("n_samples", "sample_mode"):
        assert [got[key](i) for i in range(5)] == [want[key](i) for i in range(5)]
    assert [got["n_samples"](i) for i in range(5)] == [2, 2, 3, 4, 4]
    assert str(nt.OptimizeKLConfig.from_file(cfg_file)) == str(JaxConfig.from_file(cfg_file))


def test_optimize_kl_config_run(tmp_path):
    """Config-driven MGVI on the port: the likelihood from a builder, the
    config written to the output directory."""
    cfg_file = str(tmp_path / "c.cfg")
    with open(cfg_file, "w") as f:
        f.write("[optimization]\n"
                f"output directory = {tmp_path / 'out'}\n"
                "[optimization.0]\n"
                "total iterations = 2\n"
                "n samples = 2\n"
                "sample mode = linear_resample\n"
                "likelihood = *lh\n")
    _, lht, _, _, cft, start = _pair(seed=4)
    cfg = nt.OptimizeKLConfig.from_file(cfg_file, {"lh": lambda: lht})
    samples, state = cfg.optimize_kl(nt.position_from_numpy(cft, start),
                                     key=torch.Generator().manual_seed(12),
                                     draw_linear_kwargs=dict(cg_kwargs=CG))
    assert state.nit == 2 and len(samples) == 4
    assert (tmp_path / "out" / "optimization.cfg").exists()
    assert (tmp_path / "out" / "last.pkl").exists()
