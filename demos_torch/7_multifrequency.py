"""Multifrequency imaging: a correlated field mapped over frequencies and
rendered as sRGB.

The PyTorch port's version of ``demos/7_multifrequency.py``: the field is
a ``VModel`` over 4 frequency channels (each channel its own latent), the
sky is its exponential, the data the sky plus white noise; MGVI
(``linear_resample``) fits it, and the posterior mean cube is rendered by
``plot.rgb_from_spectral_cube``.  The truth and the noise are numpy
draws.  Runs on the CUDA card in float32, or with ``--device cpu`` in
float64; ``--fast`` runs two iterations of one sample pair (the draws'
CG cut to 20 steps, the KL's Newton-CG to 5); ``--png``
writes the truth and the posterior mean side by side (with matplotlib)::

    python demos_torch/7_multifrequency.py [--device cpu] [--fast] [--png out.png]
"""

import argparse

import numpy as np
import torch

import nifty_tpu_torch as nt
from nifty_tpu_torch.device import resolve

NFREQ = 4
SHAPE = (48, 48)
NOISE_STD = 0.3


def build(device, dtype):
    """The sky: exp of the correlated field mapped over the channels."""
    cfm = nt.CorrelatedFieldMaker("mf")
    cfm.set_amplitude_total_offset(offset_mean=0.0, offset_std=(1e-1, 3e-2))
    cfm.add_fluctuations(SHAPE, distances=1.0 / SHAPE[0], fluctuations=(1.0, 5e-1),
                         loglogavgslope=(-3.5, 2e-1))
    return nt.ChainModel(torch.exp, nt.VModel(cfm.finalize(device=device, dtype=dtype),
                                              axis_size=NFREQ))


def run(device=None, fast=False, seed=11):
    """Truth, data and the MGVI fit: a dict with the truth, the data, the
    starting latent and the sky of every sample (numpy, ``(samples, 4, 48,
    48)``)."""
    device = resolve(device)
    dtype = torch.float64 if device.type == "cpu" else torch.float32
    sky = build(device, dtype)
    rng = np.random.default_rng(seed)
    draw = lambda: {k: rng.standard_normal(v.shape) for k, v in sorted(sky.domain.items())}  # noqa: E731
    with torch.no_grad():
        truth = sky(nt.position_from_numpy(sky, draw())).double().cpu().numpy()
    data = truth + NOISE_STD * rng.standard_normal(truth.shape)
    lh = nt.Gaussian(torch.as_tensor(data, dtype=dtype, device=device),
                     noise_cov_inv=1.0 / NOISE_STD**2).amend(sky)
    start = draw()
    samples, _ = nt.optimize_kl(
        lh, nt.position_from_numpy(sky, start),
        key=torch.Generator(device=device).manual_seed(seed),
        n_total_iterations=2 if fast else 4, n_samples=1 if fast else 2,
        draw_linear_kwargs=dict(cg_kwargs=dict(maxiter=20 if fast else 50)),
        kl_kwargs=dict(minimize_kwargs=dict(maxiter=5)) if fast else None,
        sample_mode="linear_resample")
    with torch.no_grad():
        fields = torch.func.vmap(sky)(samples.samples).double().cpu().numpy()
    return dict(truth=truth, data=data, start=start, fields=fields, fast=fast)


def check(out):
    """Print the NRMSE, render the mean as sRGB and assert what
    ``demos/7_multifrequency.py`` asserts."""
    truth, mean = out["truth"], out["fields"].mean(0)
    nrmse = float(np.linalg.norm(mean - truth) / np.linalg.norm(truth))
    print(f"multifrequency posterior NRMSE: {nrmse:.4f}")
    rgb = nt.plot.rgb_from_spectral_cube(mean)
    assert rgb.shape == SHAPE + (3,) and np.all((rgb >= 0) & (rgb <= 1))
    assert nrmse < 0.5, "reconstruction failed"
    return rgb


def write_png(out, rgb, name):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axs = plt.subplots(1, 2, figsize=(8, 4))
    axs[0].imshow(nt.plot.rgb_from_spectral_cube(out["truth"]))
    axs[0].set_title("truth (RGB)")
    axs[1].imshow(rgb)
    axs[1].set_title("posterior mean (RGB)")
    fig.savefig(name, dpi=120)
    plt.close(fig)
    print(f"wrote {name}")


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None, help="cpu, or the CUDA card when not given")
    parser.add_argument("--fast", action="store_true", help="two iterations of one sample pair")
    parser.add_argument("--png", default=None, help="write the truth and the mean as sRGB here")
    args = parser.parse_args(argv)
    out = run(args.device, fast=args.fast)
    rgb = check(out)
    if args.png:
        write_png(out, rgb, args.png)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
