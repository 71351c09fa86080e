"""Getting started: a 1-D correlated field under a Gaussian likelihood,
fitted by geoVI.

The PyTorch port's version of ``demos/0_intro.py``: build a
non-parametric correlated-field prior, draw a truth and noisy data from
numpy seeds, and run ``optimize_kl`` (geoVI: ``nonlinear_resample``).
Runs on the CUDA card in float32, or with ``--device cpu`` in float64;
``--fast`` shrinks the schedule (two iterations of one sample pair, the
KL's Newton-CG cut to 10 steps)::

    python demos_torch/0_intro.py [--device cpu] [--fast]
"""

import argparse

import numpy as np
import torch

import nifty_tpu_torch as nt
from nifty_tpu_torch.device import resolve

DIMS = (128,)
NOISE_COV = 0.1
DELTA = 1e-4


def build(device, dtype):
    """The demo's correlated field (power kind, with asperity)."""
    cfm = nt.CorrelatedFieldMaker("cf")
    cfm.set_amplitude_total_offset(offset_mean=2.0, offset_std=(1e-1, 3e-2))
    cfm.add_fluctuations(DIMS, distances=1.0 / DIMS[0], fluctuations=(1.0, 5e-1),
                         loglogavgslope=(-3.0, 2e-1), flexibility=(1e0, 2e-1),
                         asperity=(5e-1, 5e-2), prefix="ax1", non_parametric_kind="power")
    return cfm.finalize(device=device, dtype=dtype)


def run(device=None, fast=False, seed=42):
    """Truth, data and the geoVI fit: a dict with the truth, the data, the
    starting latent and the signal of every sample (numpy, ``(samples,
    128)``)."""
    device = resolve(device)
    dtype = torch.float64 if device.type == "cpu" else torch.float32
    signal = nt.ChainModel(torch.exp, build(device, dtype))
    rng = np.random.default_rng(seed)
    draw = lambda: {k: rng.standard_normal(v.shape) for k, v in sorted(signal.domain.items())}  # noqa: E731
    with torch.no_grad():
        truth = signal(nt.position_from_numpy(signal, draw())).double().cpu().numpy()
    data = truth + np.sqrt(NOISE_COV) * rng.standard_normal(DIMS)
    lh = nt.Gaussian(torch.as_tensor(data, dtype=dtype, device=device),
                     noise_cov_inv=1.0 / NOISE_COV).amend(signal)
    start = draw()
    samples, _ = nt.optimize_kl(
        lh, nt.position_from_numpy(signal, start),
        key=torch.Generator(device=device).manual_seed(seed),
        n_total_iterations=2 if fast else 4, n_samples=1 if fast else 4,
        draw_linear_kwargs=dict(cg_name=None, cg_kwargs=dict(absdelta=DELTA * 10.0, maxiter=100)),
        nonlinearly_update_kwargs=dict(minimize_kwargs=dict(name=None, xtol=DELTA, maxiter=5)),
        kl_kwargs=dict(minimize_kwargs=dict(name="M", xtol=DELTA, maxiter=10 if fast else 35)),
        sample_mode="nonlinear_resample")
    with torch.no_grad():
        fields = torch.func.vmap(signal)(samples.samples).double().cpu().numpy()
    return dict(truth=truth, data=data, start=start, fields=fields, fast=fast)


def check(out):
    """Print the diagnostics and assert what ``demos/0_intro.py`` asserts."""
    truth, mean, std = out["truth"], out["fields"].mean(0), out["fields"].std(0, ddof=1)
    nrmse = float(np.sqrt(np.mean((mean - truth) ** 2)) / np.sqrt(np.mean(truth**2)))
    inside = float(np.mean(np.abs(mean - truth) < 3 * std + 1e-12))
    print(f"posterior NRMSE vs truth: {nrmse:.4f}")
    print(f"fraction of truth inside mean±3std: {inside:.3f}")
    assert nrmse < (0.3 if out["fast"] else 0.2), "reconstruction failed"


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None, help="cpu, or the CUDA card when not given")
    parser.add_argument("--fast", action="store_true", help="two iterations of one sample pair")
    args = parser.parse_args(argv)
    check(run(args.device, fast=args.fast))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
