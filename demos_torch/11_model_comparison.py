"""Model comparison by the evidence lower bound.

The PyTorch port's version of ``demos/11_model_comparison.py``: data from
a 1-D correlated field with log-log slope -3 are fitted by MGVI under two
priors, the matched one (slope -3) and a stiff one (slope -6); the ELBO
(``estimate_evidence_lower_bound``, 24 eigenvalues) must prefer the
matched prior.  The truth and the noise are numpy draws.  Runs on the
CUDA card in float32, or with ``--device cpu`` in float64; ``--fast``
runs two iterations of one sample pair and 8 eigenvalues::

    python demos_torch/11_model_comparison.py [--device cpu] [--fast]
"""

import argparse

import numpy as np
import torch

import nifty_tpu_torch as nt
from nifty_tpu_torch.device import resolve

NOISE_STD = 0.05
SLOPES = {"matched (-3)": -3.0, "stiff (-6)": -6.0}


def make_model(slope_mean, device, dtype):
    cfm = nt.CorrelatedFieldMaker("m")
    cfm.set_amplitude_total_offset(offset_mean=0.0, offset_std=(1e-1, 3e-2))
    cfm.add_fluctuations((64,), distances=1.0 / 64, fluctuations=(1.0, 3e-1),
                         loglogavgslope=(slope_mean, 1e-1))
    return cfm.finalize(device=device, dtype=dtype)


def run(device=None, fast=False, seed=31):
    """The truth, the data, and for each prior its starting latent, the
    field of every sample (numpy) and its ELBO (the mean of
    ``elbo_mean``)."""
    device = resolve(device)
    dtype = torch.float64 if device.type == "cpu" else torch.float32
    rng = np.random.default_rng(seed)
    truth_model = make_model(-3.0, device, dtype)
    draw = lambda m: {k: rng.standard_normal(v.shape) for k, v in sorted(m.domain.items())}  # noqa: E731
    with torch.no_grad():
        truth = truth_model(nt.position_from_numpy(truth_model, draw(truth_model))).double().cpu().numpy()
    data = truth + NOISE_STD * rng.standard_normal(truth.shape)
    out = dict(truth=truth, data=data, start={}, fields={}, elbo={})
    gen = torch.Generator(device=device).manual_seed(seed)
    for name, slope in SLOPES.items():
        model = make_model(slope, device, dtype)
        lh = nt.Gaussian(torch.as_tensor(data, dtype=dtype, device=device),
                         noise_cov_inv=1.0 / NOISE_STD**2).amend(model)
        out["start"][name] = start = draw(model)
        samples, _ = nt.optimize_kl(
            lh, nt.position_from_numpy(model, start), key=gen,
            n_total_iterations=2 if fast else 4, n_samples=1 if fast else 2,
            draw_linear_kwargs=dict(cg_kwargs=dict(maxiter=64)), sample_mode="linear_resample")
        _, stats = nt.estimate_evidence_lower_bound(lh, samples, 8 if fast else 24, key=gen,
                                                    verbose=False)
        with torch.no_grad():
            out["fields"][name] = torch.func.vmap(model)(samples.samples).double().cpu().numpy()
        out["elbo"][name] = float(np.mean(np.asarray(stats["elbo_mean"])))
    return out


def check(out):
    """Print the ELBOs and assert what ``demos/11_model_comparison.py``
    asserts."""
    for name, elbo in out["elbo"].items():
        print(f"ELBO[{name}] = {elbo:.2f}")
    assert out["elbo"]["matched (-3)"] > out["elbo"]["stiff (-6)"], out["elbo"]
    print("model comparison prefers the matched prior, as it should")


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None, help="cpu, or the CUDA card when not given")
    parser.add_argument("--fast", action="store_true", help="two iterations, 8 eigenvalues")
    args = parser.parse_args(argv)
    check(run(args.device, fast=args.fast))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
