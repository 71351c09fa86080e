"""The port's chain samplers (``nifty_tpu_torch/hmc_oo.py``), held to
statistics: they draw from torch generators, so no run equals the JAX
package's draw for draw (the transitions themselves are held to it in
``test_torch_hmc.py``).

- ``NUTSChain`` on a 2-D standard normal with the settings and tolerances
  of ``tests/test_hmc.py::test_nuts_chain_std_normal_moments``;
- ``HMCChain``: one batch of chains equals the chains run one at a time,
  and its marginals are standard within five Monte-Carlo errors (the
  effective sample size from ``get_sample_size_estimate``).

``nuts_sample`` on a ``Likelihood`` is in ``test_torch_likelihoods.py``.
"""

import numpy as np
import torch

import nifty_tpu_torch as nt

torch.set_num_threads(1)


def test_nuts_chain_std_normal_moments():
    pot = lambda q: 0.5 * torch.sum(q**2)  # noqa: E731
    chain = nt.NUTSChain(pot, 1.0, torch.zeros(2, dtype=torch.float64), step_size=0.7,
                         max_tree_depth=8)
    out, (draws, last) = chain.generate_n_samples(0, torch.zeros(2, dtype=torch.float64), 3000)
    smpl = out.samples.numpy()[500:]
    assert out.samples.shape == (3000, 2) and out.depths.shape == out.divergences.shape == (3000,)
    assert float(out.acceptance) > 0.5
    np.testing.assert_allclose(smpl.mean(axis=0), 0.0, atol=0.15)
    np.testing.assert_allclose(smpl.std(axis=0), 1.0, atol=0.15)
    # the returned draws and position continue the chain
    more, _ = chain.generate_n_samples(draws, last, 2)
    assert more.samples.shape == (2, 2) and bool(torch.isfinite(more.samples).all())


def test_hmc_chain_batch_and_moments():
    pot = lambda q: 0.5 * (torch.sum(q["a"] ** 2) + q["b"] ** 2)  # noqa: E731
    proto = {"a": torch.zeros(2, dtype=torch.float64), "b": torch.zeros((), dtype=torch.float64)}
    chain = nt.HMCChain(pot, 1.0, proto, num_steps=16, step_size=0.25)
    start = {k: torch.zeros((3,) + v.shape, dtype=torch.float64) for k, v in proto.items()}
    vm, _ = chain.generate_n_samples([1, 2, 3], start, 5, save_intermediates=True)
    lm, _ = chain.generate_n_samples([1, 2, 3], start, 5, chain_map="lmap")
    for k in proto:
        np.testing.assert_allclose(vm.samples[k].numpy(), lm.samples[k].numpy(), rtol=1e-12, atol=1e-12)
    assert vm.samples["a"].shape == (3, 5, 2) and vm.acceptance.shape == (3,)
    assert vm.trees.accepted_qp.position["a"].shape == (3, 5, 2)
    out, _ = chain.generate_n_samples(5, {k: v[0] for k, v in start.items()}, 1500)
    assert float(out.acceptance) > 0.6
    for k in proto:
        smpl = out.samples[k][200:].reshape(1300, -1)
        ess = nt.get_sample_size_estimate(smpl).numpy()
        np.testing.assert_array_less(np.abs(smpl.std(dim=0).numpy() - 1.0), 5.0 / np.sqrt(ess))
        np.testing.assert_array_less(np.abs(smpl.mean(dim=0).numpy()), 5.0 / np.sqrt(ess))
