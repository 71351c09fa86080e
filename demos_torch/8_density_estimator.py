"""Non-parametric density estimation from event counts.

The PyTorch port's version of ``demos/8_density_estimator.py``: the
exponentiated Matérn field of ``density_estimator`` on a grid padded to
twice the size is fitted by MGVI to a histogram of numpy-drawn events
(a bimodal density on [0, 1)) under a Poisson likelihood.  Runs on the
CUDA card in float32, or with ``--device cpu`` in float64; ``--fast``
runs two iterations of one sample pair::

    python demos_torch/8_density_estimator.py [--device cpu] [--fast]
"""

import argparse

import numpy as np
import torch

import nifty_tpu_torch as nt
from nifty_tpu_torch.device import resolve

SHAPE = (64,)
N_EVENTS = 3000


def events(seed=5):
    """The histogram of the bimodal events and the events' own density."""
    rng = np.random.default_rng(seed)
    xs = np.concatenate([rng.normal(0.3, 0.06, N_EVENTS // 2), rng.normal(0.7, 0.1, N_EVENTS // 2)])
    counts, _ = np.histogram(xs, bins=SHAPE[0], range=(0.0, 1.0))
    return counts


def rate_model(device, dtype):
    """The density on the unpadded grid and the padded shape."""
    model, pshape = nt.density_estimator(SHAPE, device=device, dtype=dtype)
    cut = tuple(slice(0, s) for s in SHAPE)
    return nt.ChainModel(lambda f: f[cut], model), pshape


def run(device=None, fast=False, seed=6):
    """The fit: a dict with the counts, the starting latent and the rate of
    every sample (numpy)."""
    device = resolve(device)
    dtype = torch.float64 if device.type == "cpu" else torch.float32
    rate, _ = rate_model(device, dtype)
    counts = events()
    lh = nt.Poissonian(counts.astype(np.int64), device=device).amend(rate)
    rng = np.random.default_rng(seed)
    start = {k: rng.standard_normal(v.shape) for k, v in sorted(rate.domain.items())}
    samples, _ = nt.optimize_kl(
        lh, nt.position_from_numpy(rate, start), key=torch.Generator(device=device).manual_seed(seed),
        n_total_iterations=2 if fast else 4, n_samples=1 if fast else 2,
        draw_linear_kwargs=dict(cg_kwargs=dict(maxiter=50)), sample_mode="linear_resample")
    with torch.no_grad():
        rates = torch.func.vmap(rate)(samples.samples).double().cpu().numpy()
    return dict(counts=counts, start=start, fields=rates, fast=fast)


def check(out):
    """Print the L1 distance of the recovered density to the empirical one
    and assert what ``demos/8_density_estimator.py`` asserts."""
    emp = out["counts"] / out["counts"].sum()
    post = out["fields"].mean(0)
    l1 = float(np.abs(emp - post / post.sum()).sum())
    print(f"density L1(empirical, recovered): {l1:.4f}")
    assert l1 < 0.35


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None, help="cpu, or the CUDA card when not given")
    parser.add_argument("--fast", action="store_true", help="two iterations of one sample pair")
    args = parser.parse_args(argv)
    check(run(args.device, fast=args.fast))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
