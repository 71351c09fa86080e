"""Heteroscedastic regression with a learnt full noise covariance.

The PyTorch port's version of ``demos/13_varcov_regression.py``: a smooth
1-D signal seen in two channels (the signal and -1/2 of it) with a 2×2
noise covariance per datum that is itself inferred
(``NDVariableCovarianceGaussian``; the matrix is ``L Lᵀ + 0.05``, ``L``
latent).  The matrix square roots and inverses run through
``utils.tree_linalg`` (one batched ``eigh``, Daleckii–Krein
derivatives).  The truth and the noise are numpy draws.  Runs on the
CUDA card in float32, or with ``--device cpu`` in float64; ``--fast``
runs one iteration of one sample pair (CG 16, 5 Newton steps)::

    python demos_torch/13_varcov_regression.py [--device cpu] [--fast]
"""

import argparse

import numpy as np
import torch

import nifty_tpu_torch as nt
from nifty_tpu_torch.device import resolve

N, D = 96, 2


class MeanAndCov(nt.Model):
    """``(mean (96, 2), cov (96, 2, 2))`` from a dict position: both channels
    share the smooth signal; the covariance is ``L Lᵀ + 0.05`` of the
    latent ``nsqrt`` (drawn at 0.1)."""

    def __init__(self, sig):
        def nsqrt(generator, *, device, dtype):
            return 0.1 * torch.randn((N, D, D), generator=generator, device=device, dtype=dtype)

        super().__init__(init=sig.init | {"nsqrt": nsqrt})
        self.sig = sig

    def forward(self, x):
        s = self.sig(x)
        m = x["nsqrt"]
        eye = torch.eye(D, dtype=m.dtype, device=m.device)
        return torch.stack([s, -0.5 * s], -1), m @ m.mT + 0.05 * eye


def forward_model(device, dtype):
    """The demo's model on its smooth 1-D signal."""
    cfm = nt.CorrelatedFieldMaker("sig")
    cfm.set_amplitude_total_offset(offset_mean=0.0, offset_std=(1e-1, 3e-2))
    cfm.add_fluctuations((N,), distances=1.0 / N, fluctuations=(1.0, 3e-1),
                         loglogavgslope=(-3.5, 2e-1))
    return MeanAndCov(cfm.finalize(device=device, dtype=dtype))


def run(device=None, fast=False, seed=51):
    """Truth, data and the fit: a dict with the true mean, the data, the
    starting latent and the mean of every sample (numpy)."""
    device = resolve(device)
    dtype = torch.float64 if device.type == "cpu" else torch.float32
    fwd = forward_model(device, dtype)
    rng = np.random.default_rng(seed)
    draw = lambda scale: {k: scale.get(k, 1.0) * rng.standard_normal(v.shape)  # noqa: E731
                          for k, v in sorted(fwd.domain.items())}
    with torch.no_grad():
        mean_t, cov_t = fwd(nt.position_from_numpy(fwd, draw({"nsqrt": 0.1})))
    mean_t, cov_t = mean_t.double().cpu().numpy(), cov_t.double().cpu().numpy()
    data = mean_t + np.einsum("nij,nj->ni", np.linalg.cholesky(cov_t), rng.standard_normal((N, D)))
    lh = nt.NDVariableCovarianceGaussian(torch.as_tensor(data, dtype=dtype, device=device)).amend(fwd)
    start = draw({"nsqrt": 0.1})
    samples, _ = nt.optimize_kl(
        lh, nt.position_from_numpy(fwd, start),
        key=torch.Generator(device=device).manual_seed(seed),
        n_total_iterations=1 if fast else 4, n_samples=1 if fast else 2,
        draw_linear_kwargs=dict(cg_kwargs=dict(maxiter=16 if fast else 64)),
        kl_kwargs=dict(minimize_kwargs=dict(maxiter=5)) if fast else None,
        sample_mode="linear_resample")
    with torch.no_grad():
        means = torch.func.vmap(lambda x: fwd(x)[0])(samples.samples).double().cpu().numpy()
    return dict(truth=mean_t, data=data, start=start, fields=means)


def check(out):
    """Print the NRMSE of the posterior mean and assert what
    ``demos/13_varcov_regression.py`` asserts."""
    post = out["fields"].mean(0)
    nrmse = np.linalg.norm(post - out["truth"]) / np.linalg.norm(out["truth"])
    print(f"heteroscedastic posterior-mean NRMSE: {nrmse:.4f}")
    assert nrmse < 0.6


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None, help="cpu, or the CUDA card when not given")
    parser.add_argument("--fast", action="store_true", help="one iteration of one sample pair")
    args = parser.parse_args(argv)
    check(run(args.device, fast=args.fast))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
