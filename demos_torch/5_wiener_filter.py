"""The Wiener filter: the exact posterior of a linear Gaussian model with
a gap in the data.

The PyTorch port's version of ``demos/5_wiener_filter.py``: a fixed
power-law covariance ``S = H diag(p(k)) Hᵀ`` (the Hartley transform of
amplitude-weighted excitations), a mask over a sixth of the pixels and
white noise; ``wiener_filter_posterior`` gives the mean and 8 sample
pairs.  The truth and the noise are numpy draws.  Runs on the CUDA card
in float32, or with ``--device cpu`` in float64::

    python demos_torch/5_wiener_filter.py [--device cpu]
"""

import argparse

import numpy as np
import torch

import nifty_tpu_torch as nt
from nifty_tpu_torch.device import resolve

DIMS = (128,)
NOISE_STD = 0.02


def amplitude():
    """The square root of the fixed power spectrum on every Fourier mode."""
    p_idx, k, _ = nt.get_fourier_mode_distributor(DIMS, 1.0 / DIMS[0])
    power = 50.0 * np.where(k > 0, 1.0 / (1.0 + (k / 8.0) ** 2) ** 2, 1.0)
    return np.sqrt(power)[p_idx]


def mask():
    m = np.ones(DIMS)
    m[DIMS[0] // 3 : DIMS[0] // 2] = 0.0
    return m


def run(device=None, n_samples=8, seed=12):
    """Truth, data and the posterior: a dict with the truth, the data, the
    mask and the signal of the mean and of every sample (numpy)."""
    device = resolve(device)
    dtype = torch.float64 if device.type == "cpu" else torch.float32
    amp = torch.as_tensor(amplitude(), dtype=dtype, device=device)
    m = torch.as_tensor(mask(), dtype=dtype, device=device)

    def signal(x):
        return nt.hartley(amp * x["xi"]) / DIMS[0]

    response = nt.Model(lambda x: m * signal(x), domain={"xi": nt.ShapeWithDtype(DIMS, dtype)})
    rng = np.random.default_rng(seed)
    truth_xi = torch.as_tensor(rng.standard_normal(DIMS), dtype=dtype, device=device)
    truth = signal({"xi": truth_xi}).double().cpu().numpy()
    data = mask() * (truth + NOISE_STD * rng.standard_normal(DIMS))
    lh = nt.Gaussian(torch.as_tensor(data, dtype=dtype, device=device),
                     noise_cov_inv=1.0 / NOISE_STD**2).amend(response)
    samples, _ = nt.wiener_filter_posterior(
        lh, position={"xi": torch.zeros(DIMS, dtype=dtype, device=device)},
        key=torch.Generator(device=device).manual_seed(seed), n_samples=n_samples,
        draw_linear_kwargs=dict(cg_kwargs=dict(maxiter=200)))
    fields = torch.func.vmap(signal)(samples.samples).double().cpu().numpy()
    return dict(truth=truth, data=data, mask=mask(), fields=fields,
                mean=signal(samples.pos).double().cpu().numpy())


def check(out):
    """Print the diagnostics and assert what ``demos/5_wiener_filter.py``
    asserts."""
    obs = out["mask"] > 0
    truth, mean = out["truth"], out["mean"]
    nrmse = np.linalg.norm((mean - truth)[obs]) / np.linalg.norm(truth[obs])
    band = out["fields"].std(0)
    print(f"posterior NRMSE vs truth (observed region): {nrmse:.4f}")
    print(f"mean posterior std observed/masked: {band[obs].mean():.4f} / {band[~obs].mean():.4f}")
    assert nrmse < 0.3
    assert band[~obs].mean() > 2.0 * band[obs].mean()


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None, help="cpu, or the CUDA card when not given")
    check(run(parser.parse_args(argv).device))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
