"""Multi-grid GP: iterative charted refinement with a learned Matérn
kernel on a 2-D open grid.

The PyTorch port's version of ``demos/4_multigrid_icr.py``: an ICR field
on a 12² open grid refined twice (44² fine pixels), its covariance a
learned Matérn one; a truth from the model's own draw, Gaussian noise of
0.1 times its standard deviation, MGVI with 2 sample pairs and 3
iterations.  The truth and the noise are numpy draws.  Runs on the CUDA
card in float32, or with ``--device cpu`` in float64; ``--fast`` runs two
iterations of one sample pair, 12 CG steps a draw and 3 Newton steps a KL
minimisation::

    python demos_torch/4_multigrid_icr.py [--device cpu] [--fast]
"""

import argparse

import numpy as np
import torch

import nifty_tpu_torch as nt
from nifty_tpu_torch.bench.workload import latent_draw
from nifty_tpu_torch.device import resolve
from nifty_tpu_torch.multi_grid import ICRField, MaternCovarianceModel, SimpleOpenGrid

GRID = dict(shape0=(12, 12), depth=2, distances0=1.0, padding=1)
MATERN = dict(ndim=2, r_min=0.05, r_max=20.0, scale=(1.0, 0.3), cutoff=(2.0, 0.5),
              loglogslope=(-3.5, 0.5), n_integrate=600, n_interpolate=128)


def build(device, dtype):
    return ICRField(SimpleOpenGrid(**GRID), MaternCovarianceModel(**MATERN), offset=0.0,
                    device=device, dtype=dtype)


def run(device=None, fast=False, seed=21):
    """Truth, data and the posterior: a dict with the truth, the data, the
    noise std, the starting latent and the field of every sample (numpy)."""
    device = resolve(device)
    dtype = torch.float64 if device.type == "cpu" else torch.float32
    field = build(device, dtype)
    print(f"grid levels: {field.grid.shapes}")
    with torch.no_grad():
        truth = field(nt.position_from_numpy(field, latent_draw(field.domain, seed))).double().cpu().numpy()
    rng = np.random.default_rng(seed + 1)
    noise_std = 0.1 * float(truth.std())
    data = truth + noise_std * rng.standard_normal(truth.shape)
    lh = nt.Gaussian(torch.as_tensor(data, dtype=dtype, device=device),
                     noise_cov_inv=1.0 / noise_std**2).amend(field)
    start = latent_draw(field.domain, seed + 2)
    samples, _ = nt.optimize_kl(
        lh, nt.position_from_numpy(field, start), key=torch.Generator(device=device).manual_seed(seed),
        n_total_iterations=2 if fast else 3, n_samples=1 if fast else 2,
        draw_linear_kwargs=dict(cg_kwargs=dict(maxiter=12 if fast else 48)),
        kl_kwargs=dict(minimize_kwargs=dict(maxiter=3)) if fast else None,
        sample_mode="linear_resample")
    with torch.no_grad():
        fields = torch.func.vmap(field)(samples.samples).double().cpu().numpy()
    return dict(truth=truth, data=data, noise_std=noise_std, start=start, fields=fields)


def check(out):
    """Print the posterior's NRMSE and assert what ``demos/4_multigrid_icr.py``
    asserts."""
    truth = out["truth"]
    nrmse = np.linalg.norm(out["fields"].mean(0) - truth) / np.linalg.norm(truth)
    print(f"posterior NRMSE vs truth: {nrmse:.4f}")
    assert nrmse < 0.5, "ICR reconstruction failed"


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None, help="cpu, or the CUDA card when not given")
    parser.add_argument("--fast", action="store_true", help="two iterations of one sample pair")
    args = parser.parse_args(argv)
    check(run(args.device, fast=args.fast))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
