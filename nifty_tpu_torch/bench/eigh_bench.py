"""Batched ``torch.linalg.eigh`` of stacked symmetric matrices on the card:
which batch sizes and orders cuSOLVER's batched call takes, the ms of each
that it takes (CUDA events, median of 5 after a warm-up), and the ms of the
call that ``utils/tree_linalg.py`` makes (``_eigh``).

Usage: ``python3 nifty_tpu_torch/bench/eigh_bench.py`` on a machine with a
CUDA card; prints one JSON line per case, then the card's ``nvidia-smi``
name and power limit.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

ORDERS = (2, 3, 8, 32)
BATCHES = (1, 2, 1024, 16384, 32768, 65536, 1 << 18, 1280 * 1280)


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("eigh_bench: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", ".."))
    from nifty_tpu_torch.utils import tree_linalg

    def ms(fn):
        fn()
        times = []
        for _ in range(5):
            s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            torch.cuda.synchronize()
            times.append(s.elapsed_time(e))
        return float(np.median(times))

    def attempt(fn):
        """``{"ms": t}``, or ``{"error": ...}`` when cuSOLVER refuses the call."""
        try:
            return {"ms": ms(fn)}
        except RuntimeError as err:
            return {"error": str(err).split(",")[0][:100]}

    print(json.dumps({"bench": "eigh", "torch": torch.__version__, "cuda": torch.version.cuda,
                      "library": str(torch.backends.cuda.preferred_linalg_library())}), flush=True)
    g = torch.Generator(device="cuda").manual_seed(0)
    for d in ORDERS:
        for b in BATCHES:
            if d * d * b > (1 << 26):
                continue
            m = torch.randn((b, d, d), generator=g, device="cuda")
            m = m @ m.mT + 0.5 * torch.eye(d, device="cuda")
            print(json.dumps({"bench": "eigh", "order": d, "batch": b,
                              "one_call": attempt(lambda: torch.linalg.eigh(m)),
                              "tree_linalg": attempt(lambda: tree_linalg._eigh(m))}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
