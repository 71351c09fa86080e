#!/usr/bin/env python3
"""Where the device time of the Poisson metric apply goes, on one CUDA card.

Usage, from the root of a checkout::

    python3 nifty_tpu_torch/bench/metric_profile.py [--sizes 1280 4096]

Builds ``chip_smoke.py``'s exact-spectrum model (``bench.py``'s
parameters, :func:`nifty_tpu_torch.bench.workload.build_likelihood`) at
each size on the card in f32, applies the metric 3 times to warm up, then
traces 5 applies with ``torch.profiler`` and prints one JSON line per size:
device kernel time per apply summed by kind (K1-K4 by their kernel names,
elementwise, cat, reductions, the rest), kernel launches per apply, wall
time per apply under the profiler, and the device's busy share of that
wall time.  Run from the root of another tree of the port with this
folder, it times that tree.
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


def kernel_times(fn, calls, warmup=1):
    """Trace ``calls`` calls of ``fn`` (after ``warmup`` untraced ones) with
    ``torch.profiler``: wall ms per call under the profiler, and for each
    kernel name its device ms and launches per call."""
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
    kernels = {}
    for ev in prof.key_averages():
        dt = getattr(ev, "self_device_time_total", 0.0)
        if ev.device_type == torch.autograd.DeviceType.CUDA and dt > 0:
            kernels[ev.key] = (dt / 1e3 / calls, ev.count / calls)
    return wall_ms, kernels


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--sizes", type=int, nargs="+", default=[1280, 4096])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("metric_profile: no CUDA device", file=sys.stderr)
        return 2
    import nifty_tpu_torch as nt
    from nifty_tpu_torch.bench.workload import build_likelihood

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    dev = torch.device("cuda:0")
    for n in args.sizes:
        lh, pos, tan = build_likelihood(n, dev, torch.float32)
        p = nt.position_from_numpy(lh.forward_model, pos)
        t = nt.position_from_numpy(lh.forward_model, tan)
        wall_ms, kernels = kernel_times(lambda: lh.metric(p, t), APPLIES, warmup=3)
        by_kind = {}
        for name, (ms, count) in kernels.items():
            d = by_kind.setdefault(kind_of(name), {"ms": 0.0, "launches": 0})
            d["ms"] += ms
            d["launches"] += count
        launches = sum(d["launches"] for d in by_kind.values())
        device_ms = sum(d["ms"] for d in by_kind.values())
        print(json.dumps({"card": smi, "n": n, "applies": APPLIES,
                          "device_kernel_ms_per_apply": device_ms,
                          "kernel_launches_per_apply": launches,
                          "wall_ms_per_apply_under_profiler": wall_ms,
                          "busy_share": device_ms / wall_ms, "by_kind": by_kind}), flush=True)
        del lh, p, t
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
