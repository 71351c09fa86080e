"""Tomography: line-of-sight integrals through a 2-D correlated field.

The PyTorch port's version of ``demos/1_tomography.py``: a log-normal
density on 64² is observed through 256 rays from the left edge of the
unit square to the right one, each integral with 1 % noise, and
reconstructed by MGVI.  The response is the exact ray-cell traversal
(``ExactGridLOS``), or with ``NIFTY_TPU_LOS=sampling`` (or ``--los
sampling``) 256 interpolated points a ray (``SamplingCartesianGridLOS``).
The rays, the truth and the noise are numpy draws.  Runs on the CUDA card
in float32, or with ``--device cpu`` in float64; ``--fast`` runs two
iterations of one sample pair, the draws' CG cut to 16 steps and the KL's
Newton-CG to 5::

    python demos_torch/1_tomography.py [--device cpu] [--fast] [--los exact|sampling]
"""

import argparse
import os

import numpy as np
import torch

import nifty_tpu_torch as nt
from nifty_tpu_torch.device import resolve

SHAPE = (64, 64)
N_RAYS = 256
NOISE = 1e-2


def field(device, dtype):
    """The demo's log-density prior."""
    cfm = nt.CorrelatedFieldMaker("rho")
    cfm.set_amplitude_total_offset(offset_mean=0.0, offset_std=(1e-1, 3e-2))
    cfm.add_fluctuations(SHAPE, distances=(1.0 / SHAPE[0], 1.0 / SHAPE[1]),
                         fluctuations=(1.0, 5e-1), loglogavgslope=(-4.0, 2e-1),
                         flexibility=(8e-1, 2e-1))
    return cfm.finalize(device=device, dtype=dtype)


def rays(seed=41):
    """Start and end points ``(N_RAYS, 2)``: x = 0 to x = 1, heights uniform."""
    rng = np.random.default_rng(seed)
    start = np.stack([np.zeros(N_RAYS), rng.uniform(size=N_RAYS)], axis=1)
    end = np.stack([np.ones(N_RAYS), rng.uniform(size=N_RAYS)], axis=1)
    return start, end


def response(kind, device, dtype):
    start, end = rays()
    kw = dict(shape=SHAPE, distances=(1.0 / SHAPE[0], 1.0 / SHAPE[1]), device=device, dtype=dtype)
    if kind == "exact":
        return nt.ExactGridLOS(start, end, **kw)
    if kind == "sampling":
        return nt.SamplingCartesianGridLOS(start, end, n_sampling_points=256, **kw)
    raise ValueError(f"unknown line of sight {kind!r}: exact or sampling")


def run(device=None, fast=False, los=None, seed=42):
    """Truth, data and the MGVI fit: a dict with the data, the starting
    latent, the truth and the density of every sample (numpy)."""
    device = resolve(device)
    dtype = torch.float64 if device.type == "cpu" else torch.float32
    los = los or os.environ.get("NIFTY_TPU_LOS", "exact")
    cf = field(device, dtype)
    density = nt.ChainModel(torch.exp, cf)
    fwd = nt.ChainModel(response(los, device, dtype), density)
    rng = np.random.default_rng(seed)
    draw = lambda: {k: rng.standard_normal(v.shape) for k, v in sorted(cf.domain.items())}  # noqa: E731
    with torch.no_grad():
        truth_pos = nt.position_from_numpy(cf, draw())
        truth = density(truth_pos).double().cpu().numpy()
        line = fwd(truth_pos).double().cpu().numpy()
    noise_std = NOISE * float(line.mean())
    data = line + noise_std * rng.standard_normal(line.shape)
    lh = nt.Gaussian(torch.as_tensor(data, dtype=dtype, device=device),
                     noise_cov_inv=1.0 / noise_std**2).amend(fwd)
    start = draw()
    samples, _ = nt.optimize_kl(
        lh, nt.position_from_numpy(cf, start), key=torch.Generator(device=device).manual_seed(seed),
        n_total_iterations=2 if fast else 4, n_samples=1 if fast else 2,
        draw_linear_kwargs=dict(cg_kwargs=dict(maxiter=16 if fast else 64)),
        kl_kwargs=dict(minimize_kwargs=dict(maxiter=5)) if fast else None,
        sample_mode="linear_resample")
    with torch.no_grad():
        fields = torch.func.vmap(density)(samples.samples).double().cpu().numpy()
    return dict(data=data, noise_std=noise_std, start=start, truth=truth, fields=fields, los=los,
                fast=fast)


def check(out):
    """Print the posterior mean's error and assert what
    ``demos/1_tomography.py`` asserts."""
    truth = out["truth"]
    nrmse = np.linalg.norm(out["fields"].mean(0) - truth) / np.linalg.norm(truth)
    print(f"posterior NRMSE vs truth ({out['los']} LOS): {nrmse:.4f}")
    assert nrmse < 0.6, "tomography reconstruction failed"


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None, help="cpu, or the CUDA card when not given")
    parser.add_argument("--fast", action="store_true", help="two iterations of one sample pair, short solves")
    parser.add_argument("--los", default=None, help="exact or sampling ($NIFTY_TPU_LOS, exact)")
    args = parser.parse_args(argv)
    check(run(args.device, fast=args.fast, los=args.los))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
