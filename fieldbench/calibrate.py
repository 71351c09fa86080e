#!/usr/bin/env python3
"""The readings a cell's limits are set from, at the cell's own size.

Usage, from the root of a checkout on a machine with a CUDA card::

    python3 fieldbench/calibrate.py --workload <cell> --seeds 1 2 ... --control-seeds 7 8 9 \
        [--fault "steepest descent" --fault-seeds 4 5 6] [--out readings.jsonl]

For each of ``--seeds`` it runs the program's timed step as ``run.py`` does
(set-up, warm-up, the checked step, no measured window), for each of
``--control-seeds`` the control (the reference in the configuration's
lower precision, in the program's place), and for each of
``--fault-seeds`` the program with ``--fault`` planted
(:mod:`fieldbench.harness.faults`), and writes one JSON line a run with
every number the judge compares and every stage's gap.  The lower reading
of a number is the largest over the program's seeds, the upper the
smallest over the control's or a fault's; ``PERF.md`` gives both for each
limit.  The benchmark's own runs never run the control or a fault."""

import argparse
import contextlib
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--fault", default=None)
    ap.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    import torch

    from fieldbench.harness.control import control_step
    from fieldbench.harness.drive import drive, program_step, verdict
    from fieldbench.harness.faults import planted
    from fieldbench.harness.spec import load_cell

    if args.device == "cuda" and not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    cell = load_cell(os.path.join(os.path.dirname(HERE), "BENCHMARK.json"), args.workload)
    out = open(args.out, "a") if args.out else None
    runs = [("program", s, program_step) for s in args.seeds]
    runs += [("control", s, control_step) for s in args.control_seeds]
    runs += [(f"fault: {args.fault}", s, program_step) for s in args.fault_seeds]
    for side, seed, make in runs:
        fault = planted(args.fault, cell.traffic["kind"]) if side.startswith("fault") else contextlib.nullcontext()
        t0 = time.perf_counter()
        with fault:
            r = drive(cell, seed, args.device, make)
        t1 = time.perf_counter()
        numbers, stages = verdict(cell, r, args.device)
        line = {"workload": cell.name, "side": side, "seed": seed, "numbers": numbers,
                "stages": stages, "limits": cell.limits, "peak_bytes": int(r.peak),
                "run_s": t1 - t0, "judge_s": time.perf_counter() - t1}
        print(json.dumps(line), flush=True)
        if out:
            out.write(json.dumps(line) + "\n")
            out.flush()
        del r
    return 0


if __name__ == "__main__":
    sys.exit(main())
