"""Config-file-driven inference with ``OptimizeKLConfig``.

The PyTorch port's version of ``demos/10_config_file.py``: the VI
schedule (iteration counts, sample numbers with ``N*K`` repetitions,
sample modes) lives in an ini file, and the likelihood is referenced from
it by ``*lh``.  A 1-D correlated field under a Gaussian likelihood; the
truth and the noise are numpy draws.  Runs on the CUDA card in float32,
or with ``--device cpu`` in float64; ``--fast`` runs the schedule's two
stages one iteration each, the draws' CG cut to 20 steps, the geoVI and
KL Newton-CG to 5::

    python demos_torch/10_config_file.py [--device cpu] [--fast]
"""

import argparse
import os
import tempfile

import numpy as np
import torch

import nifty_tpu_torch as nt
from nifty_tpu_torch.device import resolve

DIMS = (48,)
NOISE_STD = 0.1

CFG = """
[optimization]
output directory = {odir}

[base.opt]
sample mode = linear_resample
likelihood = *lh

[optimization.1]
base = base.opt
total iterations = {n1}
n samples = {n1}*2

[optimization.2]
base = base.opt
total iterations = {n2}
n samples = 3
sample mode = nonlinear_update
"""


def build(device, dtype):
    cfm = nt.CorrelatedFieldMaker("cf")
    cfm.set_amplitude_total_offset(offset_mean=0.0, offset_std=(1e-1, 3e-2))
    cfm.add_fluctuations(DIMS, distances=1.0 / DIMS[0], fluctuations=(1.0, 5e-1),
                         loglogavgslope=(-3.0, 2e-1))
    return cfm.finalize(device=device, dtype=dtype)


def config_text(odir, fast=False):
    """The schedule: 2 + 2 iterations (1 + 1 with ``fast``), 2 sample pairs,
    then 3 curved by ``nonlinear_update`` (a fresh draw, the number having
    changed)."""
    n = 1 if fast else 2
    return CFG.format(odir=odir, n1=n, n2=n)


def run(device=None, fast=False, seed=1):
    """Truth, data and the config-driven fit: a dict with the truth, the
    data, the starting latent, the field of every sample (numpy) and the
    iterations run."""
    device = resolve(device)
    dtype = torch.float64 if device.type == "cpu" else torch.float32
    cf = build(device, dtype)
    rng = np.random.default_rng(seed)
    draw = lambda: {k: rng.standard_normal(v.shape) for k, v in sorted(cf.domain.items())}  # noqa: E731
    with torch.no_grad():
        truth = cf(nt.position_from_numpy(cf, draw())).double().cpu().numpy()
    data = truth + NOISE_STD * rng.standard_normal(DIMS)
    lh = nt.Gaussian(torch.as_tensor(data, dtype=dtype, device=device),
                     noise_cov_inv=1.0 / NOISE_STD**2).amend(cf)
    start = draw()
    with tempfile.TemporaryDirectory() as tmp:
        cfg_file = os.path.join(tmp, "inference.cfg")
        with open(cfg_file, "w") as f:
            f.write(config_text(os.path.join(tmp, "out"), fast))
        cfg = nt.OptimizeKLConfig.from_file(cfg_file, {"lh": lambda: lh})
        cut = dict(draw_linear_kwargs=dict(cg_kwargs=dict(maxiter=20)),
                   nonlinearly_update_kwargs=dict(minimize_kwargs=dict(maxiter=5)),
                   kl_kwargs=dict(minimize_kwargs=dict(maxiter=5))) if fast else {}
        samples, state = cfg.optimize_kl(nt.position_from_numpy(cf, start),
                                          key=torch.Generator(device=device).manual_seed(seed + 3),
                                          **cut)
    with torch.no_grad():
        fields = torch.func.vmap(cf)(samples.samples).double().cpu().numpy()
    return dict(truth=truth, data=data, start=start, fields=fields, nit=state.nit, fast=fast)


def check(out):
    """Print the NRMSE and assert what ``demos/10_config_file.py`` asserts."""
    assert out["nit"] == (2 if out["fast"] else 4)
    truth, mean = out["truth"], out["fields"].mean(0)
    nrmse = float(np.linalg.norm(mean - truth) / np.linalg.norm(truth))
    print(f"config-driven posterior NRMSE: {nrmse:.4f}")
    assert nrmse < 0.3, "reconstruction failed"


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None, help="cpu, or the CUDA card when not given")
    parser.add_argument("--fast", action="store_true", help="one iteration a stage")
    args = parser.parse_args(argv)
    check(run(args.device, fast=args.fast))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
