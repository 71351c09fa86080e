#!/usr/bin/env python3
"""Run one cell of the benchmark once.

Usage, from the root of a checkout::

    python3 fieldbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (timed from the start of this process to the first timed step)
builds the cell's system through the port's public API, makes the counts
and the position on the card from ``--seed`` and runs one warm-up step.
The window then repeats the step for ``--seconds`` seconds, each step
waiting for the last.  With ``--trace 1`` a few more steps run under the
profiler afterwards.  Once the window has closed and the peak memory is
read, the program is freed and the plain reference judges the checked
step (:mod:`fieldbench.harness.judge`).  The last line of standard output
is one JSON object: ``correct``, ``attempted``, ``failed``, ``metrics``
(the end-to-end ones, or the per-layer ones with ``--trace 1``),
``device``, with ``--trace 1`` ``breakdown``, and last ``check``, each
number compared beside its limit; the same numbers end standard error.

It exits non-zero, printing no result, without a CUDA card (or with fewer
than the cell asks for), if the port cannot be imported, or if ``jax``,
``jaxlib``, ``flax`` or the JAX package is loaded in this process once the
window has closed."""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
CHECKOUT = os.path.dirname(HERE)
sys.path.insert(0, CHECKOUT)
os.environ.setdefault("USE_FLAX", "0")  # keep libraries from loading JAX on their own

FORBIDDEN = ("jax", "jaxlib", "flax", "nifty_tpu")


def forbidden_modules(modules=None):
    """Loaded modules whose top-level name, compared whole, is forbidden."""
    names = {m.split(".", 1)[0] for m in (sys.modules if modules is None else modules)}
    return sorted(names & set(FORBIDDEN))


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def _card(device):
    import torch

    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1}, ""
    try:
        limit = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                               capture_output=True, text=True, timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        limit = "nvidia-smi unreadable"
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": 1}, limit


def run(args, device, t0=None, benchmark=None, root=HERE):
    """One run of ``args.workload`` on ``device``: ``(result, stderr lines)``."""
    from fieldbench.harness.drive import drive, verdict
    from fieldbench.harness.spec import load_cell

    cell = load_cell(benchmark or os.path.join(os.path.dirname(root), "BENCHMARK.json"),
                     args.workload, root)
    r = drive(cell, args.seed, device, seconds=args.seconds, trace=bool(args.trace), t0=t0)
    dev, power = _card(r.data.device)
    dev["memory_peak_bytes"] = int(r.peak)
    if r.summary is not None:
        dev["busy_s"], dev["window_s"] = r.summary["busy_s"], r.summary["window_s"]
    # the window has closed and the peak is read; the program is freed: judge
    t_judge = time.perf_counter()
    numbers, stages = verdict(cell, r, device)
    judge_s = time.perf_counter() - t_judge
    check = {k: {"value": numbers[k], "limit": cell.limits[k]} for k in cell.limits}
    correct = all(v["value"] <= v["limit"] for v in check.values())  # NaN fails
    if args.trace:
        metrics = {}
        for m in cell.per_layer:
            v = cell.readers[m["name"]](r.summary)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        values = {"metric_apply_ms": r.window_s * 1e3 / r.work, "vi_iter_s": r.window_s / r.work,
                  "setup_s": r.setup_s}
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]} for m in cell.end_to_end}
    result = {"correct": correct, "attempted": r.n_steps, "failed": 0 if correct else 1,
              "metrics": metrics, "device": dev}
    if r.summary is not None:
        result["breakdown"] = r.summary["breakdown"]
    result["card"] = power
    result["check"] = check
    lines = [f"judge_s {judge_s!r}"] + [f"stage {k}: {v!r}" for k, v in stages.items()]
    if r.summary is not None:
        lines.insert(0, f"summarize_s {r.summary['summarize_s']!r}")
    lines += [f"check {k}: {v['value']!r} limit {v['limit']!r}" for k, v in check.items()]
    return result, lines


def main(argv=None):
    args = parse(argv)
    try:
        import torch
    except ImportError as e:
        print(f"fieldbench: cannot import torch: {e}", file=sys.stderr)
        return 2
    from fieldbench.harness.spec import load_cell

    cell = load_cell(os.path.join(CHECKOUT, "BENCHMARK.json"), args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"fieldbench: {cell.name} needs {cell.chips} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    try:
        import nifty_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"fieldbench: the program under test is missing: {e}", file=sys.stderr)
        return 2
    try:
        result, lines = run(args, "cuda", T0)
    except Exception:
        traceback.print_exc()
        return 1
    found = forbidden_modules()
    if found:
        print(f"fieldbench: forbidden modules loaded: {found}", file=sys.stderr)
        return 3
    print("\n".join(lines), file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
