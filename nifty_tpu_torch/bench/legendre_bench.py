#!/usr/bin/env python3
"""Time K5 (``legendre_contract``) and K6 (``legendre_contract_t``) on the card.

Usage, from the root of a checkout (the ``nifty_tpu_torch`` of the working
directory is the one timed, so a parent tree unpacked elsewhere is timed by
running this file from there)::

    python3 nifty_tpu_torch/bench/legendre_bench.py --tag change [--k-sweep]

For each (nside, lmax = mmax, B) of ``--cases`` (HEALPix rings; default:
``chip_smoke.py`` phase 14a's square plans at nside 64, 256, 512 and B = 1,
2, 4, 8, 16, and nside 64 at lmax 128 with B = 256) it prints one JSON
line: device ms of each kernel (``bench.timing.device_ms``: 20 calls in a
CUDA graph), the error against the plain version in float64 on the card
(max |Δ| over max |ref|), K6's same bits on two calls, and the bound of
``bench.timing.bound`` (4 float64 flops a (l, m, ring) triple for the
recurrence, 4 B float32 flops for the contraction).  ``--k-sweep`` also
times the CUDA-core kernels with K = 2 and K = 4 rings a thread where the
tree's ``cuda_legendre.launch_config`` exists.  Each line names the card
and its power limit.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import subprocess
import sys

sys.path.insert(0, os.getcwd())

CASES = [(64, 128, B) for B in (1, 2, 4, 8, 16)] + [(256, 512, B) for B in (1, 2, 4, 8, 16)] \
    + [(512, 1024, B) for B in (1, 2, 4)] + [(64, 128, 256)]


def legendre_work(plan, B):
    """Bytes, float32 and float64 operations of one K5 or K6 call."""
    M = plan.mmax + 1
    triples = plan.n_half * sum(plan.lmax - m + 1 for m in range(M))
    n_bytes = (4 * B * plan.size + 8 * B * plan.n_rings * M
               + 16 * M * (plan.lmax + 1) + 8 * M * plan.n_half + 8 * plan.n_half)
    return n_bytes, 4.0 * B * triples, 4.0 * triples


def main() -> int:
    import torch

    from nifty_tpu_torch.bench.timing import bound, device_ms
    from nifty_tpu_torch.ops import cuda_legendre as cl
    from nifty_tpu_torch.ops import sht

    ap = argparse.ArgumentParser()
    ap.add_argument("--tag", default="tree")
    ap.add_argument("--cases", default=None, help="nside:lmax:B,... (default: the 14a shapes)")
    ap.add_argument("--k-sweep", action="store_true")
    ap.add_argument("--no-mma", action="store_true",
                    help="every batch on the CUDA-core kernels (groups of 4 samples)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("legendre_bench: no CUDA device", file=sys.stderr)
        return 2
    cases = CASES if args.cases is None else [tuple(int(v) for v in c.split(":"))
                                              for c in args.cases.split(",")]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda:0")
    g = torch.Generator(device=dev).manual_seed(0)
    configs = [None]
    if args.k_sweep and hasattr(cl, "launch_config"):
        configs += [2, 4]
    base_config = getattr(cl, "launch_config", None)
    if args.no_mma:
        cl.MMA_MIN_BATCH = 1 << 30
    plans = {}
    for nside, lmax, B in cases:
        if (nside, lmax) not in plans:
            plans.clear()
            plan = cl.LegendrePlan(sht.healpix_ring_geometry(nside)[0], lmax, lmax)
            plans[(nside, lmax)] = (plan, copy.deepcopy(plan).to(dev))
        plan, plan_d = plans[(nside, lmax)]
        alm = torch.randn((B, plan.size), generator=g, device=dev)
        cot = torch.randn((B, plan.n_rings, plan.mmax + 1, 2), generator=g, device=dev)
        ref5 = cl.legendre_contract_plain(alm.double(), plan_d)
        ref6 = cl.legendre_contract_t_plain(cot.double(), plan_d)
        n_bytes, f32, f64 = legendre_work(plan, B)
        b_ms, b_by = bound(n_bytes, f32, f64)
        for k in configs:
            if k is not None:
                cfg0 = base_config(plan, B)
                if cfg0.mma:
                    continue

                def forced(plan_, B_, transpose=False, k=k):
                    c = base_config(plan_, B_, transpose)
                    threads = min(256, 32 * -(-plan_.n_half // (32 * k)))
                    return c._replace(rings_per_thread=k, threads=threads,
                                      n_chunks=-(-plan_.n_half // (threads * k)))

                cl.launch_config = forced
            try:
                out = cl.legendre_contract(alm, plan_d)
                back = cl.legendre_contract_t(cot, plan_d)
                same = bool(torch.equal(back, cl.legendre_contract_t(cot, plan_d)))
                e5 = float((out.double() - ref5).abs().max() / ref5.abs().max())
                e6 = float((back.double() - ref6).abs().max() / ref6.abs().max())
                k5 = device_ms(lambda: cl.legendre_contract(alm, plan_d))
                k6 = device_ms(lambda: cl.legendre_contract_t(cot, plan_d))
            finally:
                if base_config is not None:
                    cl.launch_config = base_config
            line = {"tag": args.tag, "nside": nside, "lmax": lmax, "B": B, "k": k,
                    "k5_ms": k5, "k6_ms": k6, "bound_ms": b_ms, "bound_by": b_by,
                    "k5_share": b_ms / k5, "k6_share": b_ms / k6, "k5_rel_err": e5,
                    "k6_rel_err": e6, "k6_same_bits": same, "card": smi}
            if base_config is not None:
                line["config_k5"] = list(base_config(plan, B))
                line["config_k6"] = list(base_config(plan, B, True))
            print(json.dumps(line), flush=True)
        del alm, cot, ref5, ref6
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
