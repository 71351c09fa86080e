#!/usr/bin/env python3
"""Device times of K7 (the counter-based normal draw), K4r (the Hartley's
column stage on a rank's block), the pencil Hartley's stage 2, and K1r/K2r
(the mode expansion and its adjoint on a rank's rows) beside K1/K2 on the
full grid, on one CUDA card.

Usage, from the root of a checkout::

    python3 nifty_tpu_torch/bench/sharded_kernels_bench.py [--tree DIR] [--tag T]
        [--only {k7,k4r,expand}] [--split] [--sweep] [--sass] [--out FILE]

``--tree DIR`` times the ``nifty_tpu_torch`` of another tree (a parent
unpacked with ``git archive`` into an ignored directory, which builds its
own kernels), so one chip call can time parent, change, change, parent.
Per measurement one JSON line: the device time (``timing.device_ms``: 20
calls in one CUDA graph), the bound and the yardstick:

- K7: 10^8 float32 normals against ``torch.randn`` of as many; bound: the
  4 bytes an entry written over 3.35 TB/s;
- K4r at 4096² over 2, 4 and 8 ranks (B = 1 and 2) and at 10240² over 4:
  rank 0's column block on the exchange's layout (a tree without it: the
  block joined as its stage 2 joined it), against ``fft(dim=0)`` of the
  block; bound: the block read once (``8 n0 (w + 1)`` bytes a slice) and
  the packed columns written once (``8 n0 w``);
- stage 2, from the receive buffer ``(p, B, rows, w + 8)`` to the return
  exchange's send buffer: this tree's ``pencil_stages`` stage 2 and, where
  it returns chunks, the packing that ``collectives.all_to_all`` does;
- K4 at 4096² (``hartley_cols`` of a padded half spectrum);
- K1 and K2 at 4096², B = 1, 2 and 4; K1r and K2r at 4096² over 2, 4 and 8
  ranks, for rank 0 and rank p/2 (whose rows are mirror images), at B = 1
  and 2 (B = 4 over 2 ranks): K1r against K1's rows (bit-exact), K2r
  against float64 (its plain version on the card) and against itself (the
  same bits twice), beside ``index_select``/``index_add_`` over the rows'
  full-grid index; bound: table, packed index and the rows' grid each moved
  once (``chip_smoke.py`` 17a's count), and beside it the least bytes the
  range needs (the index entries of the packed points with an image in the
  rows instead of the whole index).

``--only`` times one group (K7, K4r with stage 2 and K4, or the expansion
kernels).  ``--split`` adds each launch's device time of K1r and K2r
(``torch.profiler``: K2r's fold and segment sum).  ``--table-bytes N ...``
(a tree with ``ExpandRows``) gives K2r's range CSR at N² over 2, 4 and 8
ranks: its bytes, members and touched bins, and whether K2r takes the
whole index's CSR there (``dense``).

``--sweep`` (a tree with ``cuda_fft.range_launch``) launches K4r at every
cluster size and thread count that fits, through ``cuda_fft._launch_cols``,
each checked against the plain version.  ``--sass`` counts the SASS
instructions of K7's main loop (``cuobjdump -sass`` of the built library)
and gives the issue bound: instructions a group over 4 schedulers on each
SM at the SM clock ``nvidia-smi`` reports as its maximum.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys


def smi(query):
    return subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]


def sass_loop(lib_path, pattern):
    """Instructions of the longest loop (a backward branch and the code it
    jumps back over) of the first kernel whose mangled name matches
    ``pattern`` in the library's SASS, and that kernel's name."""
    from torch.utils.cpp_extension import CUDA_HOME

    cuobjdump = os.path.join(CUDA_HOME or "/usr/local/cuda", "bin", "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", lib_path], capture_output=True, text=True,
                          check=True, timeout=300).stdout
    for part in text.split("Function : ")[1:]:
        name = part.split("\n", 1)[0].strip()
        if not re.search(pattern, name):
            continue
        instr = []  # (address, text)
        for line in part.splitlines():
            m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?);", line)
            if m:
                instr.append((int(m.group(1), 16), m.group(2).strip()))
        best = []
        for addr, ins in instr:
            m = re.search(r"\bBRA\s+(?:`\(\.L_x_\d+\)|0x([0-9a-f]+))", ins)
            if m and m.group(1) and int(m.group(1), 16) < addr:
                body = [t for a, t in instr if int(m.group(1), 16) <= a <= addr and not t.startswith("NOP")]
                if len(body) > len(best):
                    best = body
        return name, best
    return None, []


def k7_issue_bound(lib_path, entries):
    """K7's issue bound for ``entries`` f32 normals: the SASS instructions
    of the f32 kernel's main loop a group (the loop's 16-byte stores count
    its groups of four entries), over 4 schedulers on each SM at the SM
    clock ``nvidia-smi`` reports as its maximum; with that clock and the one
    it reads now."""
    import torch

    name, body = sass_loop(lib_path, r"philox_kernelIfLb1E")
    groups = sum(1 for ins in body if re.search(r"\bSTG\S*\.128\b", ins))
    per_group = len(body) / max(groups, 1)
    clock_max = float(smi("clocks.max.sm").split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return {"sass_kernel": name, "sass_loop_instructions": len(body), "sass_loop_groups": groups,
            "sass_per_group": per_group,
            "clock_max_mhz": clock_max, "clock_now_mhz": float(smi("clocks.sm").split()[0]),
            "issue_bound_ms": (entries / 4) * per_group / 32 / (4 * sms * clock_max * 1e6) * 1e3}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=None)
    ap.add_argument("--tag", default="")
    ap.add_argument("--only", choices=("k7", "k4r", "expand"), default=None)
    ap.add_argument("--split", action="store_true")
    ap.add_argument("--table-bytes", type=int, nargs="*", default=[])
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--sass", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.tree) if args.tree else os.getcwd())
    import torch

    if not torch.cuda.is_available():
        print("sharded_kernels_bench: no CUDA device", file=sys.stderr)
        return 2
    from nifty_tpu_torch import native
    from nifty_tpu_torch.bench.timing import bound, device_ms
    from nifty_tpu_torch.ops import cuda_fft as cf
    from nifty_tpu_torch.ops import cuda_normal as cn

    card = smi("name,power.limit")
    out = open(args.out, "a") if args.out else None

    def emit(obj):
        line = json.dumps({"tag": args.tag, "card": card, **obj})
        print(line, flush=True)
        if out:
            out.write(line + "\n")

    dev = torch.device("cuda:0")
    g = torch.Generator(device=dev).manual_seed(0)

    if args.only in (None, "k7"):
        N, key, leaf = 10**8, 2**61 + 12345, 3
        k7 = device_ms(lambda: cn.philox_normal(key, leaf, 0, N, torch.float32, dev))
        randn = device_ms(lambda: torch.randn(N, device=dev))
        b_ms = bound(4 * N)[0]
        line = {"kernel": "K7", "entries": N, "ms": k7, "randn_ms": randn, "bound_ms": b_ms,
                "share": b_ms / k7}
        if args.sass and hasattr(cf, "range_launch"):  # the parent's loop takes one group a trip
            line.update(k7_issue_bound(native.build(), N))
        emit(line)
    if args.only in (None, "k4r"):
        k4r_kernels(emit, dev, g, args.sweep)
    if args.only in (None, "expand"):
        expand_kernels(emit, dev, g, args.split)
    for n in args.table_bytes:
        range_tables(emit, dev, n)
    return 0


def range_tables(emit, dev, n, ranks=(2, 4, 8)):
    """K2r's range CSR of rank 0's and rank p/2's rows of an n² grid."""
    import copy

    from nifty_tpu_torch.bench.workload import grid_index

    index = copy.deepcopy(grid_index((n, n))).to(dev)
    emit({"kernel": "ExpandIndex", "n": n, "packed": index.n_packed, "bins": index.n_unique,
          "bytes": sum(t.numel() * t.element_size() for t in index.buffers())})
    for p in ranks:
        for r in (0, p // 2):
            t = index.row_tables((n, n), (r * (n // p), n // p))
            emit({"kernel": "ExpandRows", "n": n, "ranks": p, "rank": r, "bytes": t.nbytes(),
                  "members": t.perm.numel(), "touched_bins": t.n_bins, "dense": t.dense})
        index.ranges.clear()


def k4r_kernels(emit, dev, g, sweep):
    """K4 at 4096², K4r and stage 2 on rank 0's block."""
    import torch

    from nifty_tpu_torch.bench.timing import bound, device_ms, fft_flops
    from nifty_tpu_torch.ops import cuda_fft as cf
    from nifty_tpu_torch.parallel.fft import pencil_stages

    f32 = torch.float32
    exchange_layout = hasattr(cf, "range_launch")
    # K4 at 4096²
    n = 4096
    x = torch.randn((n, n), generator=g, device=dev)
    Gk = cf.hartley_rows(x)
    emit({"kernel": "K4", "n": n, "ms": device_ms(lambda: cf.hartley_cols(Gk, n)),
          "bound_ms": bound(4 * n * n + 8 * n * (n // 2 + 1))[0]})
    del x, Gk

    # K4r and stage 2, rank 0's block
    for n, p, B in ((4096, 2, 1), (4096, 4, 1), (4096, 8, 1), (4096, 2, 2), (4096, 4, 2),
                    (10240, 4, 1), (1280, 2, 1), (1280, 4, 1)):
        w, rows = n // (2 * p), n // p
        recv = torch.randn((p, B, rows, w + 8), dtype=torch.complex64, generator=g, device=dev)
        blk = torch.cat(list(recv), dim=1)  # (B, n0, w + 8), as the parent's stage 2 joined it
        if B == 1:
            blk = blk[0]
        ref = cf.hartley_cols_range_plain(blk, w)
        _, cols, _ = pencil_stages((n, n), p, f32)
        if exchange_layout:
            k4r = device_ms(lambda: cf.hartley_cols_range(recv, w, n1=n))
            got = cf.hartley_cols_range(recv, w, n1=n)
            got = got.movedim(0, 1).reshape(B, n, 2 * w)
            stage2 = device_ms(lambda: cols(recv, 0))
            joined = device_ms(lambda: cf.hartley_cols_range(blk, w, n1=n))
        else:
            k4r = device_ms(lambda: cf.hartley_cols_range(blk, w, n1=n))
            got = cf.hartley_cols_range(blk, w, n1=n)
            chunks = list(recv)
            stage2 = device_ms(lambda: torch.cat([c.contiguous().reshape(-1) for c in cols(chunks, 0)]))
            joined = k4r
        err = float((got.reshape(ref.shape) - ref).abs().max() / ref.abs().max())
        lib = device_ms(lambda: torch.fft.fft(blk[..., :w + 1], dim=-2))
        b_ms, by = bound(B * (8 * n * (w + 1) + 8 * n * w), B * fft_flops(n, w + 1))
        emit({"kernel": "K4r", "n": n, "ranks": p, "B": B, "w": w, "ms": k4r, "stage2_ms": stage2,
              "joined_layout_ms": joined, "fft_dim0_ms": lib, "bound_ms": b_ms, "bound_by": by,
              "share": b_ms / k4r, "rel_err": err,
              "launch": list(cf.range_launch(n, w, B)) if exchange_layout else None})
        if sweep and exchange_layout:
            H = torch.empty((p, B, rows, 2 * w), device=dev)
            refx = cf.hartley_cols_range_plain(recv, w)
            for parts, T in [(parts, T) for parts in cf.CLUSTERS for T in (8, 16, 32, 64)]:
                if cf._cluster_fits(n, parts, T):
                    launch = lambda: cf._launch_cols(recv, H, T, 8, parts, n1=n, n_cols=w)  # noqa: E731
                    try:
                        launch()
                        torch.cuda.synchronize()
                    except RuntimeError as e:
                        emit({"sweep": "K4r", "n": n, "ranks": p, "B": B, "T": T, "parts": parts,
                              "error": str(e)[:200]})
                        continue
                    e = float((H - refx).abs().max() / refx.abs().max())
                    emit({"sweep": "K4r", "n": n, "ranks": p, "B": B, "T": T, "parts": parts,
                          "blocks": parts * (w // 8) * B, "ms": device_ms(launch), "rel_err": e})
            del H, refx
        del recv, blk, ref, got


def needed_packed(n, lo, b):
    """The rfp2 packed points of an n² grid's core (``H = n/2 + 1``) with an
    image in the rows ``[lo, lo + b)``: pairs ``a <= b`` of core rows with
    ``a`` or ``b`` among the core rows those grid rows mirror.  Counted here,
    not by ``cuda_expand.needed_packed``, so that a parent tree is timed
    against the same bound."""
    import numpy as np

    H = n // 2 + 1
    y = np.arange(lo, lo + b)
    R = np.unique(np.where(y < H, y, n - y))
    q = H - R.size
    return H * (H + 1) // 2 - q * (q + 1) // 2


def expand_kernels(emit, dev, g, split, n=4096, ranks=(2, 4, 8)):
    """K1 and K2 on the full n² grid at B = 1, 2, 4; K1r and K2r on rank 0's
    and rank p/2's rows over ``ranks`` at B = 1, 2 (4 over 2 ranks)."""
    import copy

    import torch

    from nifty_tpu_torch.bench.metric_profile import kernel_times
    from nifty_tpu_torch.bench.timing import bound, device_ms
    from nifty_tpu_torch.bench.workload import grid_index
    from nifty_tpu_torch.ops import cuda_expand as ce

    full = (n, n)
    index = grid_index(full)
    index_d = copy.deepcopy(index).to(dev)
    U, Pk = index.n_unique, index.n_packed
    full_idx = ce.expand_to_grid_plain(
        torch.arange(U, dtype=torch.float64, device=dev), index_d, full).reshape(-1).to(torch.int32)

    def by_launch(fn):
        return {k[:80]: round(ms, 5) for k, (ms, _) in kernel_times(fn, 20)[1].items()}

    for B in (1, 2, 4):
        batch = () if B == 1 else (B,)
        tab = torch.randn((U,) + batch, generator=g, device=dev)
        cot = torch.randn(full + batch, generator=g, device=dev)
        grid = ce.expand_to_grid(tab, index_d, full)
        b_ms = bound(4 * U * B + 4 * Pk + 4 * n * n * B)[0]
        emit({"kernel": "K1", "n": n, "B": B, "ms": device_ms(lambda: ce.expand_to_grid(tab, index_d, full)),
              "bound_ms": b_ms})
        emit({"kernel": "K2", "n": n, "B": B,
              "ms": device_ms(lambda: ce.collapse_from_grid(cot, index_d, full)), "bound_ms": b_ms})
        for p in ranks:
            if B == 4 and p != 2:
                continue
            b = n // p
            for r in (0, p // 2):
                rows, sl = (r * b, b), slice(r * b, (r + 1) * b)
                cot_r, idx_r = cot[sl], full_idx[r * b * n:(r + 1) * b * n]
                exact = torch.equal(ce.expand_to_grid_rows(tab, index_d, full, rows), grid[sl])
                part = ce.collapse_from_grid_rows(cot_r, index_d, full, rows)
                again = ce.collapse_from_grid_rows(cot_r, index_d, full, rows)
                ref = ce.collapse_from_grid_rows_plain(cot_r.double(), index_d, full, rows)
                err = float((part.double() - ref).abs().max() / ref.abs().max())
                k1r = device_ms(lambda: ce.expand_to_grid_rows(tab, index_d, full, rows))
                k2r = device_ms(lambda: ce.collapse_from_grid_rows(cot_r, index_d, full, rows))
                b_ms = bound(4 * U * B + 4 * Pk + 4 * b * n * B)[0]
                need_ms = bound(4 * U * B + 4 * needed_packed(n, r * b, b) + 4 * b * n * B)[0]
                line = {"kernel": "K1r+K2r", "n": n, "ranks": p, "rank": r, "rows": b, "B": B,
                        "k1r_ms": k1r, "k2r_ms": k2r, "bound_ms": b_ms, "needed_bound_ms": need_ms,
                        "k1r_share": b_ms / k1r, "k2r_share": b_ms / k2r,
                        "k1r_exact": exact, "k2r_rel_err": err, "k2r_same_bits": torch.equal(part, again),
                        "index_select_ms": device_ms(lambda: tab.index_select(0, idx_r)),
                        "index_add_ms": device_ms(lambda: tab.new_zeros((U,) + batch).index_add_(
                            0, idx_r, cot_r.reshape((-1,) + batch)))}
                if split:
                    line["k1r_launches"] = by_launch(lambda: ce.expand_to_grid_rows(tab, index_d, full, rows))
                    line["k2r_launches"] = by_launch(lambda: ce.collapse_from_grid_rows(cot_r, index_d, full, rows))
                emit(line)
        del tab, cot, grid


if __name__ == "__main__":
    sys.exit(main())
