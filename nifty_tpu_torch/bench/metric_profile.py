#!/usr/bin/env python3
"""Where the device time of the Poisson metric apply goes, on one CUDA card.

Usage, from the root of a checkout::

    python3 nifty_tpu_torch/bench/metric_profile.py [--sizes 1280 4096] [--knots 64]

Builds ``chip_smoke.py``'s model (``bench.py``'s parameters,
:func:`nifty_tpu_torch.bench.workload.build_likelihood`; exact, or with
``--knots`` its knot form) at each size on the card in f32, applies the
metric 3 times to warm up, then traces 5 applies with ``torch.profiler``
and prints one JSON line per size: device kernel time per apply summed by
kind (K1-K4 by their kernel names, elementwise, cat, reductions, the
rest), kernel launches per apply, wall time per apply under the profiler,
and the device's busy share of that wall time.  For the knot form it adds
the device time and launches of the relu-feature map (its chunks'
kernels, also counted in their kinds), from the program's spans
``nt.pwl.features`` and ``nt.pwl.transpose`` (:mod:`nifty_tpu_torch.tracing`).
With ``--vi`` it profiles one MGVI and one geoVI iteration
(``OptimizeVI.update`` with ``chip_smoke.py`` phase 7's settings, after
one warm-up) at each size instead, the samples mapped by ``--maps``
(``vmap``, the default, or ``lmap``), with ``--knots`` knots (64 unless
given; 0 for the exact form).  With ``--nuts`` it profiles, on
``chip_smoke.py`` phase 10's model (the exact form unless ``--knots``),
4 chains from the latent that drew the counts: five batched gradients of
the chains' potential, then one ``NUTSChain`` transition of the 4 chains
(depth <= 5, step 5e-4, within phase 10's adapted steps), each after one
warm-up.  With ``--los RAYS`` the model is ``chip_smoke.py`` phase 13a's
tomography instead (the exact field through ``exp`` and ``ExactGridLOS``
over ``RAYS`` rays, :func:`nifty_tpu_torch.bench.workload.tomography`):
its metric applies, or with ``--vi`` one MGVI iteration; the LOS's
gathers are a kind of their own.  With ``--sphere`` the sizes are nsides
and the model is ``chip_smoke.py`` phase 14c's spherical field under a
Gaussian at its own draw: its metric applies, or with ``--vi`` one MGVI
iteration; K5 and K6 are kinds of their own.  Copies (the layout change of a batch between K1's trailing
sample axis and the Hartley's leading one, among others) are their own
kind.  Run from the root of another tree of the port with this folder,
it times that tree.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

sys.path.insert(0, os.getcwd())

KINDS = (  # (kind, substrings of the kernel name), first match wins
    # torch's gathers (the LOS's, among others), before K1's old name
    ("gather", ("vectorized_gather", "index_elementwise", "indexSelect", "index_copy")),
    # K1/K2: the grid kernels, and the packed ones of trees before them
    ("K1 expand", ("expand_rfp2", "expand_flat", "gather_kernel")),
    ("K2 collapse", ("collapse_fold", "segsum")),
    ("K3 hartley_rows", ("hartley_rows",)),
    ("K4 hartley_cols", ("hartley_cols",)),
    ("K6 legendre_contract_t", ("legendre_contract_t", "chunk_sum")),
    ("K5 legendre_contract", ("legendre_contract",)),
    ("copy", ("copy_kernel",)),
    ("elementwise", ("elementwise", "vectorized", "unrolled")),
    ("cat", ("CatArray", "cat_")),
    ("reductions", ("reduce", "Reduce")),
)
APPLIES = 5


def kind_of(name: str) -> str:
    for kind, keys in KINDS:
        if any(k in name for k in keys):
            return kind
    return "other"


PWL_RANGES = ("nt.pwl.features", "nt.pwl.transpose")  # the relu-feature map's spans


def kernel_times(fn, calls, warmup=1, ranges=()):
    """Trace ``calls`` calls of ``fn`` (after ``warmup`` untraced ones) with
    ``torch.profiler``: wall ms per call under the profiler, and for each
    kernel name its device ms and launches per call; with ``ranges``,
    each of these profiler ranges too (the kernels launched inside it)."""
    import time

    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / calls
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    kernels = {}
    for ev in prof.key_averages():
        dt = getattr(ev, "self_device_time_total", 0.0)
        # a user annotation (a ``record_function`` range) also shows on the
        # device, spanning its kernels: not a kernel of its own
        if ev.device_type == cuda and dt > 0 and not ev.is_user_annotation:
            kernels[ev.key] = (dt / 1e3 / calls, ev.count / calls)
    inside = {r: [0.0, 0] for r in ranges}
    for ev in prof.events() if ranges else ():
        if ev.name in inside and ev.device_type == cpu:  # the host side: its kernels below it
            inside[ev.name][0] += ev.device_time_total / 1e3 / calls
            inside[ev.name][1] += _launches_below(ev) / calls
    return (wall_ms, kernels, inside) if ranges else (wall_ms, kernels)


def _launches_below(ev):
    return len(ev.kernels) + sum(_launches_below(c) for c in ev.cpu_children)


def _line(wall_ms, kernels, inside=None, **head):
    """The JSON line of a profile: device time and launches by kind."""
    by_kind = {}
    for name, (ms, count) in kernels.items():
        d = by_kind.setdefault(kind_of(name), {"ms": 0.0, "launches": 0})
        d["ms"] += ms
        d["launches"] += count
    device_ms = sum(d["ms"] for d in by_kind.values())
    line = {**head, "device_kernel_ms_per_call": device_ms,
            "kernel_launches_per_call": sum(d["launches"] for d in by_kind.values()),
            "wall_ms_per_call_under_profiler": wall_ms,
            "busy_share": device_ms / wall_ms, "by_kind": by_kind,
            "top_kernels": [{"name": name[:100], "ms": ms, "launches": count} for name, (ms, count)
                            in sorted(kernels.items(), key=lambda kv: -kv[1][0])[:6]]}
    if inside:
        line["relu_features"] = {"ms": sum(inside[r][0] for r in PWL_RANGES),
                                 "launches": sum(inside[r][1] for r in PWL_RANGES)}
    return line


def _profile_nuts(nt, workload, n, dev, knots, ranges, head, chains=4):
    import torch

    from nifty_tpu_torch.hmc_oo import Potential, Ravel

    lh, _ = workload.build_vi_likelihood(n, dev, torch.float32, knots)
    truth = nt.position_from_numpy(lh.forward_model,
                                   workload.latent_draw(lh.forward_model.domain, 0))
    start = {k: v.unsqueeze(0).repeat((chains,) + (1,) * v.ndim) for k, v in truth.items()}
    potential = lambda q: -nt.LogDensity(lh)(q)  # noqa: E731
    ravel = Ravel(truth)
    x = ravel.ravel(start)
    grad = Potential(potential, ravel).gradient
    print(json.dumps(_line(*kernel_times(lambda: grad(x), 5, warmup=1, ranges=ranges),
                           **head, chains=chains, what="batched_gradient", calls=5)), flush=True)
    chain = nt.NUTSChain(potential, 1.0, truth, step_size=5e-4, max_tree_depth=5)
    keys = list(range(chains))
    out = {}

    def transition():
        out["chain"], _ = chain.generate_n_samples(keys, start, 1)

    line = _line(*kernel_times(transition, 1, warmup=1, ranges=ranges), **head, chains=chains,
                 what="nuts_transition", calls=1)
    line["tree_depths"] = out["chain"].depths.reshape(-1).tolist()
    print(json.dumps(line), flush=True)


def _sphere(workload, nside, dev):
    """Phase 14c's spherical field under a Gaussian at its own draw."""
    import torch

    sky = workload.sphere_field(nside, dev, torch.float32)
    return workload.gaussian_at_own_draw(sky, sky, 0.2, dev)[0]


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--sizes", type=int, nargs="+", default=[1280, 4096])
    ap.add_argument("--knots", type=int, default=None, help="the knot form with this many knots")
    ap.add_argument("--vi", action="store_true",
                    help="profile one MGVI and one geoVI iteration (chip_smoke.py phase 7) "
                         "instead of metric applies; with --knots (default 64, 0 exact)")
    ap.add_argument("--maps", choices=("vmap", "lmap"), default="vmap",
                    help="--vi: how the samples are mapped")
    ap.add_argument("--los", type=int, default=None, metavar="RAYS",
                    help="the tomography model of chip_smoke.py phase 13a with this many rays "
                         "(metric applies, or with --vi an MGVI iteration)")
    ap.add_argument("--sphere", action="store_true",
                    help="the spherical field of chip_smoke.py phase 14c at nside --sizes "
                         "(metric applies, or with --vi an MGVI iteration)")
    ap.add_argument("--nuts", action="store_true",
                    help="profile batched gradients and a NUTS transition of 4 chains "
                         "(chip_smoke.py phase 10) instead of metric applies")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("metric_profile: no CUDA device", file=sys.stderr)
        return 2
    import nifty_tpu_torch as nt
    from nifty_tpu_torch.bench import workload

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    dev = torch.device("cuda:0")
    if args.los or args.sphere:
        args.knots = None  # the tomography and the spherical fields are exact
    elif args.vi:
        args.knots = 64 if args.knots is None else args.knots or None
    ranges = PWL_RANGES if args.knots is not None else ()
    for n in args.sizes:
        head = {"card": smi, "n": n, "knots": args.knots, "rays": args.los,
                "sphere": args.sphere}
        if args.nuts:
            _profile_nuts(nt, workload, n, dev, args.knots, ranges, head)
        elif args.vi:
            if args.los:
                lh, _, start_np, _ = workload.tomography(n, args.los, dev)
                modes = ("linear_resample",)
            elif args.sphere:
                lh = _sphere(workload, n, dev)
                start_np = workload.latent_draw(lh.forward_model.domain, 2)
                modes = ("linear_resample",)
            else:
                lh, start_np = workload.build_vi_likelihood(n, dev, torch.float32, args.knots)
                modes = ("linear_resample", "nonlinear_resample")
            start = nt.Samples(pos=nt.position_from_numpy(lh.forward_model, start_np))
            opt = nt.OptimizeVI(lh, 1, kl_map=args.maps, residual_map=args.maps)
            head["maps"] = args.maps
            for mode in modes:
                state = opt.init_state(torch.Generator(device=dev).manual_seed(0),
                                       sample_mode=mode, **workload.vi_settings())
                print(json.dumps(_line(*kernel_times(lambda: opt.update(start, state), 1,
                                                     warmup=1, ranges=ranges),
                                       **head, mode=mode, calls=1)), flush=True)
            del lh, start, opt
        else:
            if args.los:
                lh, _, pos, _ = workload.tomography(n, args.los, dev)
                tan = workload.latent_draw(lh.forward_model.domain, 3)
            elif args.sphere:
                lh = _sphere(workload, n, dev)
                pos, tan = (workload.latent_draw(lh.forward_model.domain, s) for s in (51, 52))
            else:
                lh, pos, tan = workload.build_likelihood(n, dev, torch.float32,
                                                         n_mode_knots=args.knots)
            p = nt.position_from_numpy(lh.forward_model, pos)
            t = nt.position_from_numpy(lh.forward_model, tan)
            times = kernel_times(lambda: lh.metric(p, t), APPLIES, warmup=3, ranges=ranges)
            print(json.dumps(_line(*times, **head, calls=APPLIES)), flush=True)
            del lh, p, t
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
