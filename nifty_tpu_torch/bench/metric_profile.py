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
kernels, also counted in their kinds), from a profiler range around
``ops.pwl.pwl_features``/``pwl_transpose`` that only this script opens.
With ``--vi`` it profiles one MGVI and one geoVI iteration
(``OptimizeVI.update`` with ``chip_smoke.py`` phase 7's settings, after
one warm-up) at each size instead.  Run from the root of another tree of
the port with this folder, it times that tree.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

sys.path.insert(0, os.getcwd())

KINDS = (  # (kind, substrings of the kernel name), first match wins
    # K1/K2: the grid kernels, and the packed ones of trees before them
    ("K1 expand", ("expand_rfp2", "expand_flat", "gather_kernel")),
    ("K2 collapse", ("collapse_fold", "segsum")),
    ("K3 hartley_rows", ("hartley_rows",)),
    ("K4 hartley_cols", ("hartley_cols",)),
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


PWL_RANGE = "pwl_features"


def _annotate_pwl():
    """Wrap the relu-feature map's two directions in a profiler range."""
    import torch

    from nifty_tpu_torch.ops import pwl

    def ranged(fn):
        def call(*args):
            with torch.profiler.record_function(PWL_RANGE):
                return fn(*args)

        return call

    pwl.pwl_features, pwl.pwl_transpose = ranged(pwl.pwl_features), ranged(pwl.pwl_transpose)


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
        # a range also shows on the device as an annotation spanning its
        # kernels: not a kernel of its own
        if ev.device_type == cuda and dt > 0 and ev.key not in ranges:
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
        ms, count = inside[PWL_RANGE]
        line["relu_features"] = {"ms": ms, "launches": count}
    return line


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--sizes", type=int, nargs="+", default=[1280, 4096])
    ap.add_argument("--knots", type=int, default=None, help="the knot form with this many knots")
    ap.add_argument("--vi", action="store_true",
                    help="profile one MGVI and one geoVI iteration (chip_smoke.py phase 7) "
                         "instead of metric applies; with --knots (default 64)")
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
    if args.vi and args.knots is None:
        args.knots = 64
    ranges = ()
    if args.knots is not None:
        _annotate_pwl()
        ranges = (PWL_RANGE,)
    for n in args.sizes:
        head = {"card": smi, "n": n, "knots": args.knots}
        if args.vi:
            lh, start_np = workload.build_vi_likelihood(n, dev, torch.float32, args.knots)
            start = nt.Samples(pos=nt.position_from_numpy(lh.forward_model, start_np))
            opt = nt.OptimizeVI(lh, 1)
            for mode in ("linear_resample", "nonlinear_resample"):
                state = opt.init_state(torch.Generator(device=dev).manual_seed(0),
                                       sample_mode=mode, **workload.vi_settings())
                print(json.dumps(_line(*kernel_times(lambda: opt.update(start, state), 1,
                                                     warmup=1, ranges=ranges),
                                       **head, mode=mode, calls=1)), flush=True)
            del lh, start, opt
        else:
            lh, pos, tan = workload.build_likelihood(n, dev, torch.float32, n_mode_knots=args.knots)
            p = nt.position_from_numpy(lh.forward_model, pos)
            t = nt.position_from_numpy(lh.forward_model, tan)
            times = kernel_times(lambda: lh.metric(p, t), APPLIES, warmup=3, ranges=ranges)
            print(json.dumps(_line(*times, **head, calls=APPLIES)), flush=True)
            del lh, p, t
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
