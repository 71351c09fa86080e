"""NUTS sampling of a correlated-field posterior with window adaptation.

The PyTorch port's version of ``demos/3_nuts.py``: sample the standardized
posterior of a 1-D correlated-field model under Gaussian noise with the
adaptive NUTS sampler, 2 chains as one batch.  The truth and the noise are
numpy draws.  Runs on the CUDA card in float32, or with ``--device cpu``
in float64::

    python demos_torch/3_nuts.py [--device cpu]
"""

import argparse

import numpy as np
import torch

import nifty_tpu_torch as nt
from nifty_tpu_torch.device import resolve

DIMS = (64,)
NOISE_STD = 0.2


def run(device=None, n_samples=300, n_warmup=200, max_tree_depth=8, seed=33):
    """Build the model, draw the data and sample: returns a dict with the
    truth, the data, the field of every sample (``(2 · n_samples, 64)``,
    numpy) and ``nuts_sample``'s diagnostics."""
    device = resolve(device)
    dtype = torch.float64 if device.type == "cpu" else torch.float32
    cfm = nt.CorrelatedFieldMaker("cf")
    cfm.set_amplitude_total_offset(offset_mean=0.0, offset_std=(1e-1, 3e-2))
    cfm.add_fluctuations(DIMS, 1.0 / DIMS[0], (1.0, 5e-1), (-3.0, 2e-1), (1.0, 2e-1))
    cf = cfm.finalize(device=device, dtype=dtype)

    rng = np.random.default_rng(seed)
    truth_pos = {k: rng.standard_normal(v.shape) for k, v in sorted(cf.domain.items())}
    with torch.no_grad():
        truth = cf(nt.position_from_numpy(cf, truth_pos)).double().cpu().numpy()
    data = truth + NOISE_STD * rng.standard_normal(DIMS)
    lh = nt.Gaussian(torch.as_tensor(data, dtype=dtype, device=device),
                     noise_cov_inv=1.0 / NOISE_STD**2).amend(cf)

    samples, info = nt.nuts_sample(lh, seed, n_chains=2, n_samples=n_samples,
                                   n_warmup=n_warmup, max_tree_depth=max_tree_depth)
    with torch.no_grad():
        fields = torch.func.vmap(cf)(samples.samples).double().cpu().numpy()
    return dict(truth=truth, data=data, fields=fields, info=info)


def check(out):
    """Print the diagnostics and assert what ``demos/3_nuts.py`` asserts."""
    truth, post_mean = out["truth"], out["fields"].mean(axis=0)
    nrmse = np.linalg.norm(post_mean - truth) / np.linalg.norm(truth)
    acc = out["info"]["acceptance"].cpu().numpy()
    print(f"acceptance per chain: {np.round(acc, 3)}")
    print(f"divergences per chain: {out['info']['divergences'].cpu().numpy()}")
    print(f"posterior NRMSE vs truth: {nrmse:.4f}")
    assert np.all(acc > 0.4), "NUTS acceptance collapsed"
    assert nrmse < 0.8, "NUTS reconstruction failed"


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None, help="cpu, or the CUDA card when not given")
    check(run(parser.parse_args(argv).device))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
