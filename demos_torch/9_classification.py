"""Binary classification: a 2-D correlated field under a Bernoulli
likelihood.

The PyTorch port's version of ``demos/9_classification.py``: the event
probability is the sigmoid of a 64² correlated field; labels are numpy
Bernoulli draws at the probabilities of the model's own draw; MGVI fits
them.  The skill is the Brier score against a constant rate.  Runs on
the CUDA card in float32, or with ``--device cpu`` in float64;
``--fast`` runs two iterations of one sample pair::

    python demos_torch/9_classification.py [--device cpu] [--fast]
"""

import argparse

import numpy as np
import torch

import nifty_tpu_torch as nt
from nifty_tpu_torch.device import resolve

SHAPE = (64, 64)


def build(device, dtype):
    cfm = nt.CorrelatedFieldMaker("cf")
    cfm.set_amplitude_total_offset(offset_mean=0.0, offset_std=(1e-1, 3e-2))
    cfm.add_fluctuations(SHAPE, distances=1.0 / SHAPE[0], fluctuations=(2.0, 5e-1),
                         loglogavgslope=(-4.0, 2e-1))
    return nt.ChainModel(torch.sigmoid, cfm.finalize(device=device, dtype=dtype))


def run(device=None, fast=False, seed=21):
    """Truth, labels and the fit: a dict with the true probabilities, the
    labels, the starting latent and the probability of every sample
    (numpy)."""
    device = resolve(device)
    dtype = torch.float64 if device.type == "cpu" else torch.float32
    prob = build(device, dtype)
    rng = np.random.default_rng(seed)
    draw = lambda: {k: rng.standard_normal(v.shape) for k, v in sorted(prob.domain.items())}  # noqa: E731
    with torch.no_grad():
        truth = prob(nt.position_from_numpy(prob, draw())).double().cpu().numpy()
    labels = (rng.uniform(size=SHAPE) < truth).astype(np.int8)
    lh = nt.Bernoulli(labels, device=device).amend(prob)
    start = draw()
    samples, _ = nt.optimize_kl(
        lh, nt.position_from_numpy(prob, start),
        key=torch.Generator(device=device).manual_seed(seed),
        n_total_iterations=2 if fast else 4, n_samples=1 if fast else 2,
        draw_linear_kwargs=dict(cg_kwargs=dict(maxiter=50)), sample_mode="linear_resample")
    with torch.no_grad():
        fields = torch.func.vmap(prob)(samples.samples).double().cpu().numpy()
    return dict(truth=truth, labels=labels, start=start, fields=fields)


def check(out):
    """Print the Brier skill and assert what ``demos/9_classification.py``
    asserts."""
    d = out["labels"].astype(np.float64)
    brier = np.mean((out["fields"].mean(0) - d) ** 2)
    skill = 1.0 - brier / np.mean((d.mean() - d) ** 2)
    print(f"Brier skill score vs constant baseline: {skill:.4f}")
    assert skill > 0.1


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None, help="cpu, or the CUDA card when not given")
    parser.add_argument("--fast", action="store_true", help="two iterations of one sample pair")
    args = parser.parse_args(argv)
    check(run(args.device, fast=args.fast))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
