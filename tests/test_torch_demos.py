"""The port's demos (``demos_torch/``) on the CPU.

``demos_torch/3_nuts.py`` is the port's ``demos/3_nuts.py``: its own
asserts (acceptance > 0.4, NRMSE < 0.8), and its posterior mean and
standard deviation of the field against the JAX package's NUTS on the
same data and model, within Monte-Carlo error: five standard errors a
pixel, with each run's effective sample size from the lag-1
autocorrelation (``get_sample_size_estimate``), for the mean σ/√ESS and for
the standard deviation σ/√(2 ESS).  Its trees reach depth 7-8 (up to 255
leapfrog steps of two batched gradients), about half an hour on one CPU
thread, so that run is marked ``slow``; a short run of the same code
stays in the default set.
"""

import importlib.util
import os

import jax
import numpy as np
import pytest
import torch
from jax import numpy as jnp
from jax import random

import nifty_tpu as nj

torch.set_num_threads(1)
DEMOS = os.path.join(os.path.dirname(__file__), os.pardir, "demos_torch")


def _load(name):
    spec = importlib.util.spec_from_file_location(name.replace(".py", ""), os.path.join(DEMOS, name))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_nuts_demo_short_run():
    """The demo's model, data and sampling at 4 warm-up steps and 4 samples
    of depth <= 3: shapes and finite fields."""
    out = _load("3_nuts.py").run("cpu", n_samples=4, n_warmup=4, max_tree_depth=3)
    assert out["fields"].shape == (8, 64) and np.isfinite(out["fields"]).all()
    assert out["info"]["tree_depths"].shape == (2, 4)
    assert int(out["info"]["tree_depths"].max()) <= 3


def _jax_fields(mod, data):
    cfm = nj.CorrelatedFieldMaker("cf")
    cfm.set_amplitude_total_offset(offset_mean=0.0, offset_std=(1e-1, 3e-2))
    cfm.add_fluctuations(mod.DIMS, 1.0 / mod.DIMS[0], (1.0, 5e-1), (-3.0, 2e-1), (1.0, 2e-1))
    cf = cfm.finalize()
    lh = nj.Gaussian(jnp.asarray(data), noise_cov_inv=lambda x: x / mod.NOISE_STD**2).amend(cf)
    samples, info = nj.nuts_sample(lh, random.PRNGKey(33), n_chains=2, n_samples=300,
                                   n_warmup=200, max_tree_depth=8)
    fields = np.asarray(jax.vmap(cf)(samples.samples))
    return fields, np.asarray(info["acceptance"])


def _stats(fields, n_chains=2):
    """Mean, standard deviation and effective sample size a pixel."""
    from nifty_tpu_torch import get_sample_size_estimate

    chains = torch.from_numpy(fields.reshape((n_chains, -1) + fields.shape[1:]))
    ess = sum(get_sample_size_estimate(c).numpy() for c in chains)
    return fields.mean(axis=0), fields.std(axis=0), ess


@pytest.mark.slow
def test_nuts_demo_matches_jax():
    mod = _load("3_nuts.py")
    out = mod.run("cpu")
    mod.check(out)
    fields_j, acc_j = _jax_fields(mod, out["data"])
    assert np.all(acc_j > 0.4)
    m_t, s_t, ess_t = _stats(out["fields"])
    m_j, s_j, ess_j = _stats(fields_j)
    sigma = 0.5 * (s_t + s_j)
    np.testing.assert_array_less(np.abs(m_t - m_j), 5 * sigma * np.sqrt(1 / ess_t + 1 / ess_j))
    np.testing.assert_array_less(np.abs(s_t - s_j), 5 * sigma * np.sqrt(0.5 / ess_t + 0.5 / ess_j))
