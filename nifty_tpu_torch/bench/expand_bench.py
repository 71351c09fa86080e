#!/usr/bin/env python3
"""Device times of the grid expansion kernels K1 and K2 on one CUDA card.

Usage, from the root of a checkout (or of another tree of the port with
this folder, whose ``nifty_tpu_torch`` it then times)::

    python3 nifty_tpu_torch/bench/expand_bench.py [--sizes 1280 4096] [--B 1 4]

For the exact-spectrum index of each n² grid (``bench.py``'s binning) and
each batch width B, prints one JSON line: K1's and K2's device time
(``timing.device_ms``: 20 calls in one CUDA graph) beside their bound
(table, packed index and grid, each moved once, over 3.35 TB/s), and each
kernel launch's share of that time from ``torch.profiler`` (K2 is a fold
launch and one or two segment-sum launches).
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys

sys.path.insert(0, os.getcwd())


def _by_launch(fn, iters=20):
    """Device ms per call of each kernel ``fn`` launches, by kernel name."""
    from nifty_tpu_torch.bench.metric_profile import kernel_times

    out = {}
    for key, (ms, _) in kernel_times(fn, iters)[1].items():
        name = re.search(r"\w*kernel\w*", key)
        out[name.group(0) if name else key[:60]] = ms
    return out


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--sizes", type=int, nargs="+", default=[1280, 4096])
    ap.add_argument("--B", type=int, nargs="+", default=[1, 4])
    ap.add_argument("--tag", default="")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("expand_bench: no CUDA device", file=sys.stderr)
        return 2
    from nifty_tpu_torch.bench.timing import bound, device_ms
    from nifty_tpu_torch.bench.workload import grid_index
    from nifty_tpu_torch.ops import cuda_expand as ce

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    dev = torch.device("cuda:0")
    g = torch.Generator(device=dev).manual_seed(0)
    for n in args.sizes:
        full = (n, n)
        index = grid_index(full).to(dev)
        U, P, N = index.n_unique, index.n_packed, n * n
        for B in args.B:
            batch = () if B == 1 else (B,)
            tab = torch.randn((U,) + batch, generator=g, device=dev)
            cot = torch.randn(full + batch, generator=g, device=dev)
            k1 = lambda: ce.expand_to_grid(tab, index, full)
            k2 = lambda: ce.collapse_from_grid(cot, index, full)
            line = {"card": smi, "tag": args.tag, "n": n, "B": B, "P": P, "U": U,
                    "bound_ms": bound(4 * U * B + 4 * P + 4 * N * B)[0],
                    "k1_ms": device_ms(k1), "k2_ms": device_ms(k2),
                    "k1_launches": _by_launch(k1), "k2_launches": _by_launch(k2)}
            print(json.dumps(line), flush=True)
            del tab, cot
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
