#!/usr/bin/env python3
"""Device times of the Hartley kernels K3 and K4 on one CUDA card.

Usage, from the root of a checkout (or of another tree of the port with
this folder, whose ``nifty_tpu_torch`` it then times)::

    python3 nifty_tpu_torch/bench/hartley_bench.py [--sizes 1280 4096 10240]
    python3 nifty_tpu_torch/bench/hartley_bench.py --sweep   # launch shapes

Prints one JSON line per measurement: device time (``timing.device_ms``:
20 calls in one CUDA graph), the bound (134.3 MB per pass at 4096²:
one f32 array and one complex64 half spectrum over 3.35 TB/s), and
``rfft``, the one PyTorch call that computes K3's function.  ``--sweep``
launches the kernels at every launch shape that fits (threads per row
pair or column, columns per block, blocks per cluster) through the
wrappers' own launch helpers and checks each against the plain version;
``--out FILE`` appends the lines to a file as well.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

sys.path.insert(0, os.getcwd())


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--sizes", type=int, nargs="+", default=[1280, 4096, 10240])
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--tag", default="")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("hartley_bench: no CUDA device", file=sys.stderr)
        return 2
    from nifty_tpu_torch.bench.timing import bound, device_ms
    from nifty_tpu_torch.ops import cuda_fft as cf

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    out = open(args.out, "a") if args.out else None

    def emit(obj):
        line = json.dumps({"tag": args.tag, "card": smi, **obj})
        print(line, flush=True)
        if out:
            out.write(line + "\n")

    dev = torch.device("cuda:0")
    g = torch.Generator(device=dev).manual_seed(0)
    for n in args.sizes:
        x = torch.randn((n, n), generator=g, device=dev)
        Gp = cf.hartley_rows_plain(x)
        Gk = cf.padded_half_spectrum(Gp)
        Hp = cf.hartley_cols_plain(Gp, n)
        bound_ms = bound(4 * n * n + 8 * n * (n // 2 + 1))[0]  # one real array, one half spectrum
        if not args.sweep:
            k3 = device_ms(lambda: cf.hartley_rows(x))
            k4 = device_ms(lambda: cf.hartley_cols(Gk, n))
            rfft = device_ms(lambda: cf.hartley_rows_plain(x))
            emit({"n": n, "k3_ms": k3, "k4_ms": k4, "rfft_ms": rfft, "bound_ms": bound_ms})
            continue
        G = torch.empty((n, cf.half_spectrum_pitch(n)), dtype=torch.complex64, device=dev)
        H = torch.empty((n, n), dtype=torch.float32, device=dev)
        shapes = [("K3", T, 1, 0) for T in sorted({64, 128, 256, 512, n // 16})]
        shapes += [("K4", T, tc, parts) for T in sorted({32, 64, 128, n // 32})
                   for tc, parts in ((1, 0), (2, 0), (8, 2), (8, 4))]
        for kernel, T, tc, parts in shapes:
            if kernel == "K3":
                smem, threads = cf.row_smem_bytes(n), T
            else:
                smem, threads = cf.col_smem_bytes(n, tc, parts), (tc + (parts > 0)) * T
            if T > n // 16 or threads > cf.MAX_THREADS or smem > cf.SMEM_LIMIT:
                continue
            if kernel == "K3":
                def run():
                    cf._launch_rows(x, G, T)
                run()
                err = float((G[:, : n // 2 + 1] - Gp).abs().max() / Gp.abs().max())
            else:
                def run():
                    cf._launch_cols(Gk, H, T, tc, parts)
                run()
                err = float((H - Hp).abs().max() / Hp.abs().max())
            emit({"n": n, "kernel": kernel, "threads": T, "columns": tc, "parts": parts,
                  "smem": smem, "rel_err": err, "ms": device_ms(run), "bound_ms": bound_ms})
        emit({"n": n, "chosen": {"K3": cf.row_launch(n), "K4": cf.col_launch(n)}})
        del x, Gp, Gk, Hp, G, H
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
