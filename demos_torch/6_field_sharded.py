"""Domain-decomposed inference: a correlated field row-sharded over ranks
(the ≥10⁹-parameter execution mode).

The PyTorch port's version of ``demos/6_field_sharded.py``.  The field's
leading axis is split over the mesh axis ``"fx"`` of ``torch.distributed``
ranks, one a card: the Hartley transform is the pencil transform with two
explicit ``all_to_all`` exchanges, every reduction of CG and Newton-CG a
sum over the ranks, and a rank holds O(N/p) of the field.  Truth, noise
and the start are numpy draws of the whole field; each rank keeps its
rows.  The script starts its ranks itself: ``--ranks N`` gloo processes
on the CPU (float64), or on the card one NCCL rank a card (float32)::

    python demos_torch/6_field_sharded.py --device cpu --ranks 2 [--fast]
    python demos_torch/6_field_sharded.py            # the card, one rank
"""

import argparse
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch

if __package__ in (None, ""):  # run as a script from a checkout
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir))

import nifty_tpu_torch as nt  # noqa: E402
from nifty_tpu_torch import parallel  # noqa: E402
from nifty_tpu_torch.device import resolve  # noqa: E402
from nifty_tpu_torch.parallel.mesh import gather_axis  # noqa: E402

NOISE_STD = 0.2


def shape_of(ranks, fast=False):
    """The reference's grid, ``(32 p, 64)``; ``fast``: ``(16 p, 32)``."""
    return (16 * ranks, 32) if fast else (32 * ranks, 64)


def field(shape, device, dtype, mesh):
    cfm = nt.CorrelatedFieldMaker("cf")
    cfm.set_amplitude_total_offset(offset_mean=0.0, offset_std=(1e-1, 3e-2))
    cfm.add_fluctuations(shape, distances=1.0 / shape[0], fluctuations=(1.0, 5e-1),
                         loglogavgslope=(-3.0, 2e-1), flexibility=(1e0, 2e-1))
    # the one argument that turns on domain decomposition
    return cfm.finalize(device=device, dtype=dtype, field_mesh=mesh)


def run(device=None, rank=0, ranks=1, store=None, fast=False, seed=42):
    """This rank's part of the demo; returns on every rank the whole truth,
    data, start latent (numpy), posterior fields (one a sample) and their
    mean, and the NRMSE of the mean against the truth."""
    device = resolve(device)
    dtype = torch.float64 if device.type == "cpu" else torch.float32
    store = store or os.path.join(tempfile.mkdtemp(), "store")
    parallel.initialize(store, ranks, rank, device=device.type)
    mesh = parallel.global_mesh(("fx",))
    shape = shape_of(ranks, fast)
    cf = field(shape, device, dtype, mesh)
    sh = cf.position_sharding()
    rows = sh["cfxi"]
    rng = np.random.default_rng(seed)
    truth_latent = {k: rng.standard_normal(v.shape) for k, v in sorted(cf.domain.items())}
    noise = NOISE_STD * rng.standard_normal(shape)
    start = {k: 0.1 * rng.standard_normal(v.shape) for k, v in sorted(cf.domain.items())}
    with torch.no_grad():
        truth = cf(nt.position_from_numpy(cf, truth_latent, sharding=sh))
    data = truth + rows.shard(torch.as_tensor(noise, dtype=dtype, device=device))
    lh = nt.Gaussian(data, noise_std_inv=lambda x: 5.0 * x).amend(cf)
    samples, _ = nt.optimize_kl(
        lh, nt.position_from_numpy(cf, start, sharding=sh),
        key=torch.Generator(device=device).manual_seed(seed),
        n_total_iterations=2 if fast else 4, n_samples=2,
        draw_linear_kwargs=dict(cg_kwargs=dict(absdelta=1e-6, maxiter=60)),
        kl_kwargs=dict(minimize_kwargs=dict(xtol=1e-6, maxiter=20)),
        sample_mode="linear_resample", position_sharding=sh)
    with torch.no_grad():
        fields = torch.stack([cf(s) for s in samples])  # this rank's rows of each sample
    group = mesh.get_group("fx")
    whole = lambda x, axis: gather_axis(x, axis, group).double().cpu().numpy()  # noqa: E731
    fields, truth, data = whole(fields, 1), whole(truth, 0), whole(data, 0)
    mean = fields.mean(0)
    nrmse = float(np.sqrt(np.mean((mean - truth) ** 2) / np.mean(truth**2)))
    torch.distributed.destroy_process_group()
    return dict(truth=truth, data=data, start=start, fields=fields, mean=mean, nrmse=nrmse,
                shape=shape, ranks=ranks)


def check(out):
    """Print the diagnostics and assert what ``demos/6_field_sharded.py``
    asserts."""
    print(f"ranks: {out['ranks']}, field: {out['shape']} ({np.prod(out['shape']):.0f} dof)")
    print(f"nrmse vs truth: {out['nrmse']:.3f}")
    assert out["nrmse"] < 0.6


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None, help="cpu, or the CUDA card when not given")
    parser.add_argument("--ranks", type=int, default=1, help="processes, one a card (or CPU)")
    parser.add_argument("--fast", action="store_true", help="the small grid, 2 iterations")
    parser.add_argument("--out", default=None, help="rank 0 saves its results here (.npz)")
    parser.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    parser.add_argument("--store", default=None, help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.ranks > 1 and args.rank is None:  # start the ranks, each this script
        store = os.path.join(tempfile.mkdtemp(), "store")
        cmd = [sys.executable, os.path.abspath(__file__), "--ranks", str(args.ranks),
               "--store", store] + (["--device", args.device] if args.device else [])
        cmd += (["--fast"] if args.fast else []) + (["--out", args.out] if args.out else [])
        procs = [subprocess.Popen(cmd + ["--rank", str(r)]) for r in range(args.ranks)]
        codes = [p.wait() for p in procs]
        return max(codes, key=abs)
    rank = args.rank or 0
    out = run(args.device, rank, args.ranks, args.store, args.fast)
    if rank == 0:
        check(out)
        if args.out:
            np.savez(args.out, **{k: v for k, v in out.items() if k not in ("start", "shape")},
                     **{f"start/{k}": v for k, v in out["start"].items()})
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
