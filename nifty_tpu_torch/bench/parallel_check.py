"""The row-sharded field across ranks, one card a rank: correctness and times.

Usage (from the root of a checkout)::

    python3 nifty_tpu_torch/bench/parallel_check.py --ranks 4 [--shape 4096] [--vi 1280]
    python3 nifty_tpu_torch/bench/parallel_check.py --ranks 4 --device cpu --shape 512 --vi 256 \
        --tomography 256 --rays 512 --nuts 64
    python3 nifty_tpu_torch/bench/parallel_check.py --ranks 4 --large
    python3 nifty_tpu_torch/bench/parallel_check.py --ranks 2 --device cpu --large --nufft-shape 256 \
        --nufft-points 4096 --large-shapes 1024x512:16 128x64x16:8
    python3 nifty_tpu_torch/bench/parallel_check.py --ranks 4 --learned
    python3 nifty_tpu_torch/bench/parallel_check.py --ranks 4 --device cpu --learned --nufft-shape 256 \
        --learned-points 4098 --vi 256

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
   and the seconds of an iteration at ``bench.workload.vi_settings``;
4. demo 1 at full width (``bench.workload.tomography``: the exact
   ``tomography``² field through ``exp`` and ``ExactGridLOS`` over
   ``rays`` rays) on the row-sharded field, the rank's share of the rays'
   data: its metric inside the field context against the unsharded
   (relative L2 1e-5), and one MGVI iteration by ``position_sharding=``
   against the unsharded at CG 3 (1e-4), with the seconds of each;
5. ``optimize_kl`` of 4. with ``odir``: two iterations against one and a
   resume (1e-4), ``last.pkl`` (written by rank 0) against the gathered
   samples, bit for bit;
6. ``nuts_sample(chain_map="pmap")`` of ``nuts``² exact (chip_smoke.py's
   phase 10 settings: 4 chains, 8 warm-up and 4 samples, depth 5), a block
   of chains a rank, against the same chains by ``"lmap"`` on the rank's own
   card (with one chain a rank, the same arithmetic: batches of one), the
   same tree depths and relative L2 1e-2 (a whole run amplifies float32
   rounding: 4 gloo ranks at 64² part from the 4-chain batch by 1.7e-3,
   another chain by O(1)), with the seconds of each and of ``"vmap"``;
9. radio imaging with learned coordinates (``bench.workload.
   learned_nufft_likelihood``: ``VariablePositionNufft`` of the exact
   ``--nufft-shape``² field's exp at ``--learned-points`` points, the
   coordinates ``base + 1e-4 uv`` with ``uv`` a replicated latent; 2^20 + 2
   points share unevenly over 4 ranks): its metric inside the field
   context against the unsharded one on the rank's own card (relative L2
   1e-4) and one MGVI iteration over 4 mirrored sample pairs by
   ``position_sharding=`` against the unsharded at CG 3, of the unsharded
   step (1e-3), with the seconds of each, of cutting a position's taps on
   the rank, the taps the iteration cut and its peak memory on the rank;
10. two ``("samples", "fx")`` meshes of shape (1, 2), over ranks {0, 1}
   and {2, 3} (every rank builds both), each running its own
   ``optimize_kl`` of ``build_vi_likelihood``'s exact ``vi``² field with
   ``odir=`` and a ``kl_reduce`` of its own (the 4 samples weighted),
   side by side, against the same run on the rank's own card at CG 3
   (1e-4), ``last.pkl`` (written by each mesh's first rank) against its
   gathered samples, bit for bit, with the seconds of each mesh's run.

``--learned`` runs checks 9-10 alone.  With ``--large`` it runs instead
the large-field surface:

7. the sharded NUFFT's likelihood of radio imaging at full width
   (``bench.workload.nufft_likelihood``: the exact ``--nufft-shape``²
   field through ``exp`` and ``nufft2`` at ``--nufft-points`` uv points,
   the rank's share of the visibilities): its metric inside the field
   context against the unsharded one on the rank's own card (relative L2
   1e-5) and one MGVI iteration by ``position_sharding=`` against the
   unsharded at CG 3 (1e-4), with the seconds of each;
8. ``tests/test_large_field.py:_run_step`` (``bench.workload.
   large_field_step``: CG-3 draws from one key, one Newton-CG step of CG
   2, ``kl_map="smap"``, float32) at 10240² knot64 and 8192²×16 knot64
   (1.07·10⁹ dof), each rank's peak ``torch.cuda.max_memory_allocated``,
   the step's seconds, ξ's rows a rank (n0/p) and the energy finite.  A
   size that runs out of device memory is reported with the memory at
   the failure, and 8192²×8 (5.4·10⁸) is tried after it.

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

TOL = {"hartley": 1e-6, "metric": 1e-5, "vi": 1e-4, "chains": 1e-2,
       # check 7's MGVI iteration against the unsharded, of the unsharded step: 1.9e-5
       # on four H100s (4.6e-9 of the position over a step of 2.47e-4 of it)
       "vi_step": 1e-3,
       # check 9: f32 taps and derivatives weighted in float64, against the unsharded's
       # f32 autograd of the window (chip_smoke.py's 17h)
       "learned_metric": 1e-4}
KL_WEIGHTS = (0.4, 0.1, 0.3, 0.2)  # check 10's kl_reduce: the weights of the 4 samples
LEARNED_SAMPLES = 4  # check 9's sample pairs: 8 sets of coordinates in each KL evaluation
LARGE = ("10240x10240:64", "8192x8192x16:64")  # _run_step's 1.05e8 and 1.07e9 dof
FALLBACK = "8192x8192x8:64"  # tried after a size that does not fit
NUTS = dict(n_chains=4, n_warmup=8, n_samples=4, max_tree_depth=5, step_size=1e-3)  # chip_smoke.py's MCMC


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
    from nifty_tpu_torch import io
    from nifty_tpu_torch.bench.workload import (build_likelihood, build_vi_likelihood, latent_draw,
                                                sharded_tomography, short_vi_settings, tomography,
                                                vi_settings)
    from nifty_tpu_torch.ops import cuda_fft as cfft

    torch.backends.cuda.matmul.allow_tf32 = False
    parallel.initialize(args.store, args.ranks, args.rank, device=args.device)
    if args.large:
        return _large(args)
    if args.learned:
        results, failed = _learned(args)
        return _finish(args, results, failed)
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

    def vi(lh, pos, settings, n_total_iterations=1, **kw):
        return nt.optimize_kl(lh, pos, key=torch.Generator(device=dev).manual_seed(81),
                              n_total_iterations=n_total_iterations, sample_mode="linear_resample",
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
    del lh_x, lh_s, whole

    # 4. demo 1 at full width on the row-sharded field
    nt_ = args.tomography
    lh_t, _, start_np, _ = tomography(nt_, args.rays, dev)
    tan_np = latent_draw(lh_t.forward_model.domain, 3)
    lh_ts = sharded_tomography(lh_t, mesh)
    cf_s = lh_ts.forward_model.inner.inner
    sh = cf_s.position_sharding()
    rows = [k for k, v in sh.items() if v.split_axes()]
    ps, ts = (nt.position_from_numpy(cf_s, v, sharding=sh) for v in (start_np, tan_np))
    pw, tw = (nt.position_from_numpy(lh_t.forward_model, v) for v in (start_np, tan_np))
    with parallel.field_sharded(mesh.get_group("fx"), rows):
        ms = lh_ts.metric(ps, ts)
        med, all_s = seconds(lambda: lh_ts.metric(ps, ts), args.reps)
    mf = lh_t.metric(pw, tw)
    report({"check": "tomography_metric", "shape": [nt_, nt_], "rays": args.rays, "ranks": p,
            "ms_median": 1e3 * med, "ms_all": [1e3 * s for s in all_s],
            "unsharded_ms_median": 1e3 * seconds(lambda: lh_t.metric(pw, tw), args.reps)[0]},
           _rel(ms, {k: sh[k].shard(v) for k, v in mf.items()}), TOL["metric"])
    del ms, mf, ts, tw
    ref = vi(lh_t, pw, short)
    got = vi(lh_ts, ps, short, position_sharding=sh)
    settings = vi_settings()
    med, all_s = seconds(lambda: vi(lh_ts, ps, settings, position_sharding=sh), args.reps)
    report({"check": "tomography_mgvi_iteration", "by": "position_sharding", "shape": [nt_, nt_],
            "rays": args.rays, "ranks": p, "s_median": med, "s_all": all_s,
            "unsharded_s_median": seconds(lambda: vi(lh_t, pw, settings), args.reps)[0]},
           _rel(got.pos, {k: sh[k].shard(v) for k, v in ref.pos.items()}), TOL["vi"])

    # 5. odir: two iterations, and one then a resume
    od = os.path.join(os.path.dirname(args.store), "odir")
    t0 = time.perf_counter()
    straight = vi(lh_ts, ps, short, 2, position_sharding=sh, odir=os.path.join(od, "straight"))
    vi(lh_ts, ps, short, 1, position_sharding=sh, odir=os.path.join(od, "resumed"))
    resumed = vi(lh_ts, ps, short, 2, position_sharding=sh, odir=os.path.join(od, "resumed"), resume=True)
    secs = time.perf_counter() - t0
    whole = nt.OptimizeVI(lh_ts, 2, position_sharding=sh).gather(straight)
    same = True
    if rank == 0:
        saved = io.load_samples(os.path.join(od, "straight", "last.pkl"), "cpu")
        same = all(torch.equal(saved.pos[k], v.cpu()) for k, v in whole.pos.items())
    report({"check": "odir_resume", "by": "position_sharding", "shape": [nt_, nt_], "ranks": p,
            "seconds_three_runs": secs, "last_pkl_equals_gathered": same},
           _rel(resumed.pos, straight.pos) if same else float("inf"), TOL["vi"])
    del lh_t, lh_ts, cf_s, ps, pw, ref, got, straight, resumed, whole
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # 6. NUTS chains across the ranks
    lh_m, _ = build_vi_likelihood(args.nuts, dev, f32, None)
    truth = latent_draw(lh_m.forward_model.domain, 0)
    start = nt.position_from_numpy(lh_m.forward_model, {
        k: np.repeat(v[None], NUTS["n_chains"], axis=0) for k, v in truth.items()}, batch=(NUTS["n_chains"],))
    runs = {}
    for cmap in ("lmap", "vmap", "pmap"):
        t0 = time.perf_counter()
        runs[cmap] = nt.nuts_sample(lh_m, 21, initial_position=start, chain_map=cmap, **NUTS)[1]
        sync()
        runs[cmap]["seconds"] = time.perf_counter() - t0
    got, want = runs["pmap"], runs["lmap"]
    depths = torch.equal(got["tree_depths"].cpu(), want["tree_depths"].cpu())
    report({"check": "nuts_pmap", "shape": [args.nuts, args.nuts], "ranks": p, **NUTS,
            "s": got["seconds"], "lmap_s": want["seconds"], "vmap_s": runs["vmap"]["seconds"],
            "same_tree_depths": depths, "tree_depths": got["tree_depths"].tolist(),
            "rel_l2_vs_vmap": _rel(got["chain_samples"], runs["vmap"]["chain_samples"])},
           _rel(got["chain_samples"], want["chain_samples"]) if depths else float("inf"),
           TOL["chains"])
    del lh_m, start, runs
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    more, more_failed = _learned(args)
    return _finish(args, results + more, failed + more_failed)


def _finish(args, results, failed):
    """Rank 0 prints a JSON line a check; 1 where a check failed."""
    import torch.distributed as dist

    dist.destroy_process_group()
    if args.rank == 0:
        for line in results:
            print(json.dumps(line), flush=True)
    return 1 if failed else 0


def _learned(args):
    """Checks 9 and 10 on this rank: ``(results, failed)``."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    from torch.utils._pytree import tree_map

    import nifty_tpu_torch as nt
    from nifty_tpu_torch import io, parallel
    from nifty_tpu_torch.bench.workload import (build_vi_likelihood, learned_nufft_likelihood,
                                                learned_position, short_vi_settings)
    from nifty_tpu_torch.parallel import NamedSharding
    from nifty_tpu_torch.parallel.nufft import NufftPlan, taps_cut

    dev = parallel.multihost.backend_device() if args.device != "cpu" else torch.device("cpu")
    rank, p, f32 = args.rank, args.ranks, torch.float32
    mesh = parallel.global_mesh(("fx",))
    results, failed = [], []
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()
        dist.barrier()

    def timed(fn):
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        return out, time.perf_counter() - t0

    def report(line, err, tol):
        got = [None] * p
        dist.all_gather_object(got, float(err))
        line.update(err=max(got), tol=tol, ok=max(got) <= tol)
        results.append(line)
        if not max(got) <= tol:
            failed.append(line["check"])

    # 9. radio imaging with learned coordinates
    n, m = args.nufft_shape, args.learned_points
    lh, cf, base, start_np, tan_np = learned_nufft_likelihood(n, m, dev, f32)
    lh_s, cf_s, _, _, _ = learned_nufft_likelihood(n, m, dev, f32, field_mesh=mesh)
    sh = {**cf_s.position_sharding(), "uv": NamedSharding(mesh, ())}
    rows = [k for k, v in sh.items() if v.split_axes()]
    ps, ts = (learned_position(cf_s, v, dev, f32, sh) for v in (start_np, tan_np))
    pw, tw = (learned_position(cf, v, dev, f32) for v in (start_np, tan_np))
    cut = lambda tree: {k: sh[k].shard(v) for k, v in tree.items()}  # noqa: E731
    with parallel.field_sharded(mesh.get_group("fx"), rows):
        ms, first_s = timed(lambda: lh_s.metric(ps, ts))
        again = [timed(lambda: lh_s.metric(ps, ts))[1] for _ in range(args.reps)]
        energy = float(lh_s(ps))
    mf, whole_s = timed(lambda: lh.metric(pw, tw))
    e_rel = abs(energy - float(lh(pw))) / abs(float(lh(pw)))
    _, cut_s = timed(lambda: NufftPlan((n, n), base + 1e-4 * (ps["uv"] + 0.01), p).taps(
        rank, dev, f32, deriv=True))
    report({"check": "learned_nufft_metric", "shape": [n, n], "points": m, "ranks": p,
            "first_s": first_s, "s_median": float(np.median(again)), "s_all": again,
            "unsharded_s": whole_s, "energy_rel_err": e_rel, "taps_cut_s": cut_s},
           max(_rel(ms, cut(mf)), e_rel), TOL["learned_metric"])
    del ms, mf, ts, tw

    def vi(lh_, pos, **kw):
        return nt.optimize_kl(lh_, pos, key=torch.Generator(device=dev).manual_seed(81),
                              n_total_iterations=1, sample_mode="linear_resample",
                              **dict(short_vi_settings(), **kw))[0]

    ref, ref_s = timed(lambda: vi(lh, pw, n_samples=LEARNED_SAMPLES))
    if cuda:
        mem0 = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    cut0 = taps_cut()
    got, got_s = timed(lambda: vi(lh_s, ps, position_sharding=sh, n_samples=LEARNED_SAMPLES))
    peak_gib = (torch.cuda.max_memory_allocated() - mem0) / 2**30 if cuda else None
    mine, start = cut(ref.pos), cut(pw)
    step = {k: mine[k].double() - start[k].double() for k in mine}
    report({"check": "learned_nufft_mgvi_iteration", "by": "position_sharding", "shape": [n, n],
            "points": m, "ranks": p, "settings": "CG 3", "samples": 2 * LEARNED_SAMPLES, "s": got_s,
            "unsharded_s": ref_s, "taps_cut": taps_cut() - cut0, "peak_gib": peak_gib,
            "step_rel_l2": _rel(ref.pos, pw), "rel_l2": _rel(got.pos, mine)},
           _rel({k: got.pos[k].double() - start[k].double() for k in mine}, step), TOL["vi_step"])
    del lh, lh_s, cf, cf_s, ps, pw, ref, got, base  # the plans go with the likelihood
    if cuda:
        torch.cuda.empty_cache()

    # 10. two (1, 2) meshes side by side, each its own optimize_kl with odir and a kl_reduce
    halves = [DeviceMesh(dev.type, torch.tensor([[2 * h, 2 * h + 1]]), mesh_dim_names=("samples", "fx"))
              for h in range(p // 2)]
    half = halves[rank // 2]
    weights = torch.tensor(KL_WEIGHTS, dtype=torch.float64)
    reduce = lambda t: tree_map(lambda v: torch.tensordot(weights.to(v.device, v.dtype), v, dims=1), t)  # noqa: E731
    nv = args.vi
    lh_x, start_np = build_vi_likelihood(nv, dev, f32, None)
    lh_h, _ = build_vi_likelihood(nv, dev, f32, None, field_mesh=half)
    sh = lh_h.forward_model.inner.position_sharding()
    whole = nt.position_from_numpy(lh_x.forward_model, start_np)
    od = os.path.join(os.path.dirname(args.store), f"half{rank // 2}")
    ref = vi(lh_x, whole, kl_reduce=reduce)
    t0 = time.perf_counter()
    got = vi(lh_h, nt.position_from_numpy(lh_h.forward_model, start_np, sharding=sh),
             position_sharding=sh, kl_reduce=reduce, odir=od)
    if cuda:
        torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    gathered = nt.OptimizeVI(lh_h, 1, position_sharding=sh).gather(got)
    same = True
    if rank % 2 == 0:  # each mesh's first rank wrote its checkpoint
        saved = io.load_samples(os.path.join(od, "last.pkl"), "cpu")
        same = all(torch.equal(saved.pos[k], v.cpu()) for k, v in gathered.pos.items())
    report({"check": "half_meshes_optimize_kl", "by": "position_sharding", "mesh": [1, 2],
            "meshes": [[2 * h, 2 * h + 1] for h in range(p // 2)], "shape": [nv, nv],
            "kl_reduce": list(KL_WEIGHTS), "settings": "CG 3", "s_by_rank": None,
            "last_pkl_equals_gathered": same},
           _rel(gathered.pos, ref.pos) if same else float("inf"), TOL["vi"])
    every = [None] * p
    dist.all_gather_object(every, secs)
    results[-1]["s_by_rank"] = every
    return results, failed


def _large(args):
    """Checks 7 and 8 on this rank (``--large``)."""
    import numpy as np
    import torch
    import torch.distributed as dist

    import nifty_tpu_torch as nt
    from nifty_tpu_torch import parallel
    from nifty_tpu_torch.bench.workload import large_field_step, nufft_likelihood, short_vi_settings

    dev = parallel.multihost.backend_device() if args.device != "cpu" else torch.device("cpu")
    rank, p, f32 = args.rank, args.ranks, torch.float32
    mesh = parallel.global_mesh(("fx",))
    results, failed = [], []
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()
        dist.barrier()

    def timed(fn):
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        return out, time.perf_counter() - t0

    def every(value):
        """``value`` of every rank, in rank order."""
        got = [None] * p
        dist.all_gather_object(got, value)
        return got

    def report(line, err, tol):
        err = max(every(float(err)))
        line.update(err=err, tol=tol, ok=err <= tol)
        results.append(line)
        if not err <= tol:
            failed.append(line["check"])

    # 7. the sharded NUFFT at full width
    n, m = args.nufft_shape, args.nufft_points
    lh, cf, _, start_np, tan_np = nufft_likelihood(n, m, dev, f32)
    lh_s, cf_s, _, _, _ = nufft_likelihood(n, m, dev, f32, field_mesh=mesh)
    sh = cf_s.position_sharding()
    rows = [k for k, v in sh.items() if v.split_axes()]
    ps, ts = (nt.position_from_numpy(cf_s, v, sharding=sh) for v in (start_np, tan_np))
    pw, tw = (nt.position_from_numpy(cf, v) for v in (start_np, tan_np))
    with parallel.field_sharded(mesh.get_group("fx"), rows):
        ms, first_s = timed(lambda: lh_s.metric(ps, ts))
        again = [timed(lambda: lh_s.metric(ps, ts))[1] for _ in range(args.reps)]
        energy = float(lh_s(ps))
    mf, whole_s = timed(lambda: lh.metric(pw, tw))
    e_rel = abs(energy - float(lh(pw))) / abs(float(lh(pw)))
    report({"check": "nufft_metric", "shape": [n, n], "points": m, "ranks": p, "first_s": first_s,
            "s_median": float(np.median(again)), "s_all": again, "unsharded_s": whole_s,
            "energy_rel_err": e_rel},
           max(_rel(ms, {k: sh[k].shard(v) for k, v in mf.items()}), e_rel), TOL["metric"])
    del ms, mf, ts, tw

    def vi(lh_, pos, **kw):
        return nt.optimize_kl(lh_, pos, key=torch.Generator(device=dev).manual_seed(81),
                              n_total_iterations=1, sample_mode="linear_resample",
                              **short_vi_settings(), **kw)[0]

    ref, ref_s = timed(lambda: vi(lh, pw))
    got, got_s = timed(lambda: vi(lh_s, ps, position_sharding=sh))
    # held against the unsharded run's step, ~2.5e-4 of the position (TOL["vi_step"])
    mine = {k: sh[k].shard(v) for k, v in ref.pos.items()}
    start = {k: sh[k].shard(v) for k, v in pw.items()}
    step = {k: mine[k].double() - start[k].double() for k in mine}
    report({"check": "nufft_mgvi_iteration", "by": "position_sharding", "shape": [n, n],
            "points": m, "ranks": p, "settings": "CG 3", "s": got_s, "unsharded_s": ref_s,
            "step_rel_l2": _rel(ref.pos, pw), "rel_l2": _rel(got.pos, mine)},
           _rel({k: got.pos[k].double() - start[k].double() for k in mine}, step), TOL["vi_step"])
    del lh, lh_s, cf, cf_s, ps, pw, ref, got
    if cuda:
        torch.cuda.empty_cache()

    # 8. the large-field VI step
    sizes, i = list(args.large_shapes), 0
    while i < len(sizes):
        spec = sizes[i]
        dims, knots = spec.split(":")
        shape = tuple(int(d) for d in dims.split("x"))
        if cuda:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        line = {"check": "large_field_step", "shape": list(shape), "knots": int(knots),
                "dof": int(np.prod(shape)), "ranks": p, "kl_map": "smap"}
        try:
            (cfl, x, energy), secs = timed(lambda: large_field_step(shape, int(knots), dev,
                                                                    field_mesh=mesh))
            xi = x[cfl.xi_key]
            ok = (tuple(xi.shape) == (shape[0] // p,) + shape[1:] and cfl.rows == (rank * shape[0] // p,
                  shape[0] // p) and xi.dtype == f32 and bool(np.isfinite(energy)))
            line.update(seconds=secs, energy=energy, xi_rows_a_rank=int(xi.shape[0]))
            del cfl, x, xi
            err = 0.0 if ok else float("inf")
        except torch.cuda.OutOfMemoryError as e:
            line.update(out_of_memory=str(e).splitlines()[0][:300])
            err = float("inf")
            if FALLBACK not in sizes:
                sizes.insert(i + 1, FALLBACK)
        if cuda:
            line.update(peak_allocated_gib_by_rank=every(torch.cuda.max_memory_allocated() / 2**30),
                        allocated_gib_at_end_by_rank=every(torch.cuda.memory_allocated() / 2**30))
        report(line, err, 0.0)
        i += 1
    return _finish(args, results, failed)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--ranks", type=int, default=4)
    parser.add_argument("--device", default=None, help="cpu (gloo), or the cards (NCCL)")
    parser.add_argument("--shape", type=int, default=4096)
    parser.add_argument("--vi", type=int, default=1280)
    parser.add_argument("--reps", type=int, default=5)
    parser.add_argument("--tomography", type=int, default=1280, help="demo 1's grid (check 4)")
    parser.add_argument("--rays", type=int, default=16384, help="demo 1's rays (check 4)")
    parser.add_argument("--nuts", type=int, default=1280, help="the NUTS grid (check 6)")
    parser.add_argument("--large", action="store_true", help="checks 7-8 in place of 1-6 and 9-10")
    parser.add_argument("--learned", action="store_true", help="checks 9-10 alone")
    parser.add_argument("--learned-points", type=int, default=2**20 + 2,
                        help="the learned coordinates' points (check 9)")
    parser.add_argument("--nufft-shape", type=int, default=4096, help="the NUFFT's image (check 7)")
    parser.add_argument("--nufft-points", type=int, default=2**22, help="its uv points (check 7)")
    parser.add_argument("--large-shapes", nargs="+", default=list(LARGE),
                        help="the steps of check 8 as n0xn1[xn2]:knots")
    parser.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    parser.add_argument("--store", default=None, help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.rank is not None:
        return _rank(args)
    store = os.path.join(tempfile.mkdtemp(), "store")
    cmd = [sys.executable, os.path.abspath(__file__), "--store", store, "--ranks", str(args.ranks),
           "--shape", str(args.shape), "--vi", str(args.vi), "--reps", str(args.reps),
           "--tomography", str(args.tomography), "--rays", str(args.rays), "--nuts", str(args.nuts),
           "--nufft-shape", str(args.nufft_shape), "--nufft-points", str(args.nufft_points),
           "--learned-points", str(args.learned_points), "--large-shapes", *args.large_shapes]
    cmd += ["--device", args.device] if args.device else []
    cmd += ["--large"] if args.large else []
    cmd += ["--learned"] if args.learned else []
    procs = [subprocess.Popen(cmd + ["--rank", str(r)]) for r in range(args.ranks)]
    codes = [pr.wait() for pr in procs]
    if args.device != "cpu":
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)
    return max(codes, key=abs)


if __name__ == "__main__":
    sys.exit(main())
