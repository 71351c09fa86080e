"""Parametric variational inference: mean-field and full-covariance ADVI.

The PyTorch port's version of ``demos/12_parametric_vi.py``: a mildly
nonlinear 8-dimensional regression (``tanh`` of a random linear map,
Gaussian noise) is approximated by a diagonal and a full-covariance
Gaussian, each fitted by ``torch.optim.Adam`` (lr 1e-2) on the
reparametrised negative ELBO, 4 draws a step.  The matrix, the truth and
the noise are numpy draws.  Runs on the CUDA card in float32, or with
``--device cpu`` in float64; ``--fast`` takes 100 steps instead of 600::

    python demos_torch/12_parametric_vi.py [--device cpu] [--fast]
"""

import argparse

import numpy as np
import torch

import nifty_tpu_torch as nt
from nifty_tpu_torch.device import resolve

DIM, NDATA = 8, 32
NOISE_STD = 0.05


def forward_model(A):
    return nt.Model(lambda p: torch.tanh(A @ p["x"]), domain={"x": nt.ShapeWithDtype((DIM,))})


def run(device=None, fast=False, seed=41):
    """The truth and both fits: a dict with the truth's signal, the data,
    the starting latent, and each family's final loss (at fresh draws), the signal of its mean
    and 256 posterior draws of the latent (numpy)."""
    device = resolve(device)
    dtype = torch.float64 if device.type == "cpu" else torch.float32
    rng = np.random.default_rng(seed)
    A_np = np.random.default_rng(0).standard_normal((NDATA, DIM)) / np.sqrt(DIM)
    fwd = forward_model(torch.as_tensor(A_np, dtype=dtype, device=device))
    x_truth = rng.standard_normal(DIM)
    truth = np.tanh(A_np @ x_truth)
    data = truth + NOISE_STD * rng.standard_normal(NDATA)
    lh = nt.Gaussian(torch.as_tensor(data, dtype=dtype, device=device),
                     noise_cov_inv=1.0 / NOISE_STD**2).amend(fwd)
    start = {"x": rng.standard_normal(DIM)}
    pos0 = nt.position_from_numpy(fwd, start, device=device, dtype=dtype)
    steps = 100 if fast else 600
    out = dict(truth=truth, data=data, x_truth=x_truth, start=start, fast=fast)
    for name, cls in (("mean-field", nt.MeanFieldVI), ("full-cov", nt.FullCovarianceVI)):
        vi = cls(lh, pos0, n_samples=4)
        vi.fit(seed + len(name), n_steps=steps)
        with torch.no_grad():
            loss = float(vi.loss(vi.params, seed + 100 + len(name)))
            smpls = vi.posterior_samples(seed + 200 + len(name), 256).samples["x"]
        out[name] = dict(loss=loss, signal=fwd(vi.mean).double().cpu().numpy(),
                         samples=smpls.double().cpu().numpy())
    return out


def check(out):
    """Print the losses and errors and assert what
    ``demos/12_parametric_vi.py`` asserts after its 600 steps: the
    full-covariance family contains the mean-field one, so its loss is not
    much worse (after the fast run's 100 steps it has not caught up)."""
    mf, fc = out["mean-field"]["loss"], out["full-cov"]["loss"]
    print(f"negative-ELBO  mean-field: {mf:.2f}  full-cov: {fc:.2f}")
    for name in ("mean-field", "full-cov"):
        sig = out[name]["signal"]
        print(f"{name} posterior-mean NRMSE: "
              f"{np.linalg.norm(sig - out['truth']) / np.linalg.norm(out['truth']):.4f}")
    if not out["fast"]:
        assert fc < mf + 5.0


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None, help="cpu, or the CUDA card when not given")
    parser.add_argument("--fast", action="store_true", help="100 Adam steps instead of 600")
    args = parser.parse_args(argv)
    check(run(args.device, fast=args.fast))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
