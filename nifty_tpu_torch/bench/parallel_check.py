"""The row-sharded field across ranks, one card a rank: correctness and times.

Usage (from the root of a checkout)::

    python3 nifty_tpu_torch/bench/parallel_check.py --ranks 4 [--shape 4096] [--vi 1280]
    python3 nifty_tpu_torch/bench/parallel_check.py --ranks 4 --device cpu --shape 512 --vi 256

It starts ``--ranks`` processes (NCCL, rank r on card r; gloo with
``--device cpu``), float32, and on every rank, against the same work done
unsharded on the rank's own card:

1. ``sharded_hartley2`` of a seeded ``shape``² array (K3 on the rank's
   rows, two ``all_to_all_single`` exchanges, K4r on its column block)
   against ``hartley2d`` of the whole array: 1e-6 of max|H|;
2. the Fisher metric of ``bench.workload.build_likelihood``'s field, exact
   and 64 knots, row-sharded, against the unsharded (the rank's rows of ξ,
   the replicated leaves whole): relative L2 1e-5 (the replicated leaves'
   cotangents are float32 sums of each rank's rows, added over the ranks:
   another order of a sum that cancels; 4 gloo ranks at 512² part by
   3.6e-6, one rank on the card by 9e-9);
3. one MGVI iteration of ``build_vi_likelihood``'s exact field at ``vi``²
   by ``optimize_kl`` with ``position_sharding=`` and, separately, with
   ``devices=`` (each rank its share of ``ranks`` sample pairs), against
   the unsharded iteration from the same seed with CG and Newton-CG cut to
   3 steps (past that, rounding grows without bound): relative L2 1e-4;
   and the seconds of an iteration at ``bench.workload.vi_settings``.

Times are host seconds around work that ends in a synchronize and a
barrier (the slowest rank's), the median of ``--reps`` after one warm-up.
Rank 0 prints one JSON line a check, then the card's name and power limit
(nvidia-smi), and exits 0 only when every check on every rank held.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

TOL = {"hartley": 1e-6, "metric": 1e-5, "vi": 1e-4}


def _rel(got, ref):
    num = sum(float(((got[k].double() - ref[k].double()) ** 2).sum()) for k in ref)
    return (num / sum(float((ref[k].double() ** 2).sum()) for k in ref)) ** 0.5


def _rank(args):
    import numpy as np
    import torch
    import torch.distributed as dist

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir, os.pardir))
    import nifty_tpu_torch as nt
    from nifty_tpu_torch import parallel
    from nifty_tpu_torch.bench.workload import (build_likelihood, build_vi_likelihood,
                                                short_vi_settings, vi_settings)
    from nifty_tpu_torch.ops import cuda_fft as cfft

    torch.backends.cuda.matmul.allow_tf32 = False
    parallel.initialize(args.store, args.ranks, args.rank, device=args.device)
    dev = parallel.multihost.backend_device() if args.device != "cpu" else torch.device("cpu")
    rank, p, f32 = args.rank, args.ranks, torch.float32
    mesh = parallel.global_mesh(("fx",))
    n = args.shape
    results, failed = [], []

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()
        dist.barrier()

    def seconds(fn, reps):
        fn()
        sync()
        out = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            sync()
            out.append(time.perf_counter() - t0)
        return float(np.median(out)), out

    def worst(value):
        """The largest of ``value`` over the ranks."""
        t = torch.tensor(float(value), dtype=torch.float64, device=parallel.multihost.backend_device())
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        return float(t)

    def report(line, err, tol):
        err = worst(err)
        line.update(err=err, tol=tol, ok=err <= tol)
        results.append(line)
        if not err <= tol:
            failed.append(line["check"])

    # 1. the pencil Hartley
    x = torch.randn((n, n), generator=torch.Generator(device=dev).manual_seed(1), device=dev)
    H = cfft.hartley2d(x)
    b = n // p
    xr = x[rank * b:(rank + 1) * b].contiguous()
    hs = parallel.sharded_hartley2(xr, mesh)
    err = float((hs - H[rank * b:(rank + 1) * b]).abs().max() / H.abs().max())
    med, all_s = seconds(lambda: parallel.sharded_hartley2(xr, mesh), args.reps)
    report({"check": "sharded_hartley2", "shape": [n, n], "ranks": p, "ms_median": 1e3 * med,
            "ms_all": [1e3 * s for s in all_s],
            "unsharded_ms_median": 1e3 * seconds(lambda: cfft.hartley2d(x), args.reps)[0]},
           err, TOL["hartley"])
    del x, H, xr, hs

    # 2. the metric, exact and 64 knots
    for knots in (None, 64):
        lh, pos_np, tan_np = build_likelihood(n, dev, f32, n_mode_knots=knots)
        lhs, _, _ = build_likelihood(n, dev, f32, n_mode_knots=knots, field_mesh=mesh)
        sh = lhs.forward_model.inner.position_sharding()
        ps, ts = (nt.position_from_numpy(lhs.forward_model, v, sharding=sh) for v in (pos_np, tan_np))
        pf, tf = (nt.position_from_numpy(lh.forward_model, v) for v in (pos_np, tan_np))
        ms, mf = lhs.metric(ps, ts), lh.metric(pf, tf)
        err = _rel(ms, {k: sh[k].shard(v) for k, v in mf.items()})
        med, all_s = seconds(lambda: lhs.metric(ps, ts), args.reps)
        report({"check": "sharded_metric", "variant": "exact" if knots is None else f"knot{knots}",
                "shape": [n, n], "ranks": p, "ms_median": 1e3 * med, "ms_all": [1e3 * s for s in all_s],
                "unsharded_ms_median": 1e3 * seconds(lambda: lh.metric(pf, tf), args.reps)[0]},
               err, TOL["metric"])
        del lh, lhs, ps, ts, pf, tf, ms, mf
        if dev.type == "cuda":
            torch.cuda.empty_cache()

    # 3. one MGVI iteration by position_sharding= and by devices=
    nv = args.vi
    lh_x, start_np = build_vi_likelihood(nv, dev, f32, None)
    lh_s, _ = build_vi_likelihood(nv, dev, f32, None, field_mesh=mesh)
    sh = lh_s.forward_model.inner.position_sharding()
    short = short_vi_settings()

    def vi(lh, pos, settings, **kw):
        return nt.optimize_kl(lh, pos, key=torch.Generator(device=dev).manual_seed(81),
                              n_total_iterations=1, sample_mode="linear_resample",
                              **settings, **kw)[0]

    whole = nt.position_from_numpy(lh_x.forward_model, start_np)
    for by, lh, pos, kw, n_pairs in (
        ("position_sharding", lh_s, nt.position_from_numpy(lh_s.forward_model, start_np, sharding=sh),
         dict(position_sharding=sh), 2),
        ("devices", lh_x, whole, dict(devices=parallel.sample_mesh()), p),
    ):
        ref = vi(lh_x, whole, dict(short, n_samples=n_pairs))
        got = vi(lh, pos, dict(short, n_samples=n_pairs), **kw)
        want = {k: sh[k].shard(v) for k, v in ref.pos.items()} if by == "position_sharding" else ref.pos
        err = _rel(got.pos, want)
        settings = dict(vi_settings(), n_samples=n_pairs)
        med, all_s = seconds(lambda: vi(lh, pos, settings, **kw), args.reps)
        report({"check": "mgvi_iteration", "by": by, "shape": [nv, nv], "ranks": p,
                "sample_pairs": n_pairs, "s_median": med, "s_all": all_s,
                "unsharded_s_median": seconds(lambda: vi(lh_x, whole, settings), args.reps)[0]},
               err, TOL["vi"])
    dist.destroy_process_group()
    if rank == 0:
        for line in results:
            print(json.dumps(line), flush=True)
    return 1 if failed else 0


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--ranks", type=int, default=4)
    parser.add_argument("--device", default=None, help="cpu (gloo), or the cards (NCCL)")
    parser.add_argument("--shape", type=int, default=4096)
    parser.add_argument("--vi", type=int, default=1280)
    parser.add_argument("--reps", type=int, default=5)
    parser.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    parser.add_argument("--store", default=None, help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.rank is not None:
        return _rank(args)
    store = os.path.join(tempfile.mkdtemp(), "store")
    cmd = [sys.executable, os.path.abspath(__file__), "--store", store, "--ranks", str(args.ranks),
           "--shape", str(args.shape), "--vi", str(args.vi), "--reps", str(args.reps)]
    cmd += ["--device", args.device] if args.device else []
    procs = [subprocess.Popen(cmd + ["--rank", str(r)]) for r in range(args.ranks)]
    codes = [pr.wait() for pr in procs]
    if args.device != "cpu":
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)
    return max(codes, key=abs)


if __name__ == "__main__":
    sys.exit(main())
