"""All-sky inference: a correlated field on the HEALPix sphere.

The PyTorch port's version of ``demos/2_sphere.py``: a spherical
correlated field at nside 16 (the spherical-harmonic synthesis, K5 and
K6 on the card), a truth from the model's own draw, Gaussian noise of 0.3
times its standard deviation, MGVI with 2 sample pairs and 3 iterations.
The truth and the noise are numpy draws.  Runs on the CUDA card in
float32, or with ``--device cpu`` in float64; ``--fast`` runs two
iterations of one sample pair, 12 CG steps a draw and 3 Newton steps a KL
minimisation::

    python demos_torch/2_sphere.py [--device cpu] [--fast]
"""

import argparse

import numpy as np
import torch

import nifty_tpu_torch as nt
from nifty_tpu_torch.device import resolve

NSIDE = 16


def build(device, dtype):
    cfm = nt.CorrelatedFieldMaker("sky")
    cfm.set_amplitude_total_offset(offset_mean=0.0, offset_std=(1e-1, 3e-2))
    cfm.add_fluctuations((NSIDE,), distances=None, fluctuations=(1.0, 0.5),
                         loglogavgslope=(-3.0, 0.5), flexibility=(1.0, 0.3),
                         harmonic_type="spherical")
    return cfm.finalize(device=device, dtype=dtype)


def run(device=None, fast=False, seed=7):
    """Truth, data and the posterior: a dict with the truth, the data, the
    noise std, the starting latent and the map of every sample (numpy)."""
    device = resolve(device)
    dtype = torch.float64 if device.type == "cpu" else torch.float32
    sky = build(device, dtype)
    rng = np.random.default_rng(seed)
    draw = lambda: {k: rng.standard_normal(v.shape) for k, v in sorted(sky.domain.items())}  # noqa: E731
    with torch.no_grad():
        truth = sky(nt.position_from_numpy(sky, draw())).double().cpu().numpy()
    noise_std = 0.3 * float(truth.std())
    data = truth + noise_std * rng.standard_normal(truth.shape)
    lh = nt.Gaussian(torch.as_tensor(data, dtype=dtype, device=device),
                     noise_cov_inv=1.0 / noise_std**2).amend(sky)
    start = draw()
    samples, _ = nt.optimize_kl(
        lh, nt.position_from_numpy(sky, start), key=torch.Generator(device=device).manual_seed(seed),
        n_total_iterations=2 if fast else 3, n_samples=1 if fast else 2,
        draw_linear_kwargs=dict(cg_kwargs=dict(maxiter=12 if fast else 48)),
        kl_kwargs=dict(minimize_kwargs=dict(maxiter=3)) if fast else None,
        sample_mode="linear_resample")
    with torch.no_grad():
        fields = torch.func.vmap(sky)(samples.samples).double().cpu().numpy()
    return dict(truth=truth, data=data, noise_std=noise_std, start=start, fields=fields)


def check(out):
    """Print the posterior's NRMSE and assert what ``demos/2_sphere.py``
    asserts."""
    truth = out["truth"]
    nrmse = np.linalg.norm(out["fields"].mean(0) - truth) / np.linalg.norm(truth)
    print(f"posterior NRMSE vs truth: {nrmse:.4f}")
    assert nrmse < 0.7, "spherical reconstruction failed"


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None, help="cpu, or the CUDA card when not given")
    parser.add_argument("--fast", action="store_true", help="two iterations of one sample pair")
    args = parser.parse_args(argv)
    check(run(args.device, fast=args.fast))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
