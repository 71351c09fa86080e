"""Tiny copies of the benchmark's cells for the CPU tests: the same files
under a temporary root, every grid cut to 64² (the knot form to 8 knots)
and the limits set for that size.

The tiny limits, from CPU readings at 64² (seeds 11-16): the program's
``apply_ratio`` 0.5-5.6, the controls' from 270 (TF32) and 23,400
(bfloat16); the program's ``direction_gap`` up to 8.3e-5, CG without its
``β`` from 0.5; the program's ``state_gap`` up to 4.9e-6, the controls'
from 3e-6, a fault's 1e-2 (an answer altered by 1 %) to 1; a truncated
solve is ``cg_iterations_off`` 2 to 15, the program 0."""

from __future__ import annotations

import json
import os
import shutil

FIELDBENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCHMARK = os.path.join(os.path.dirname(FIELDBENCH), "BENCHMARK.json")
CELLS = ("knot64_10240.cg", "exact_4096.mgvi", "knot64_10240.mgvi_short")
# a cell whose files are here but which BENCHMARK.json leaves out (PERF.md §7):
# the tiny copies add it by an entry alone, as a later PR would
WAITING = {"configs": [{"name": "cf_poisson_exact_4096", "file": "fieldbench/configs/cf_poisson_exact_4096.json"}],
           "workloads": [{"name": "exact_4096.mgvi", "config": "cf_poisson_exact_4096",
                          "traffic": "mgvi", "chips": 1}],
           "metrics": ["vi_iter_s", "vi.draw_s", "vi.kl_s", "launches.vi", "device_idle_pct.vi",
                       "peak_mem_gib.vi", "step_mfu.vi"]}
TINY_LIMITS = {"apply_ratio": 25.0, "direction_gap": 5e-3, "cg_iterations_off": 0.0, "state_gap": 1e-4}


def tiny_root(tmp_path, side=64, knots=8):
    """A copy of ``fieldbench/`` and ``BENCHMARK.json`` under ``tmp_path``
    with every configuration cut to ``side``²; returns the copy's
    ``fieldbench/``."""
    root = os.path.join(str(tmp_path), "fieldbench")
    shutil.copytree(FIELDBENCH, root, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    with open(BENCHMARK) as f:
        bench = json.load(f)
    bench["configs"] += WAITING["configs"]
    bench["workloads"] += WAITING["workloads"]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if m["name"] in WAITING["metrics"]:
            m["workloads"].append("exact_4096.mgvi")
    with open(os.path.join(str(tmp_path), "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    for name in os.listdir(os.path.join(root, "configs")):
        path = os.path.join(root, "configs", name)
        with open(path) as f:
            cfg = json.load(f)
        cfg["model"]["grid_side"] = side
        if cfg["model"].get("n_mode_knots"):
            cfg["model"]["n_mode_knots"] = knots
        with open(path, "w") as f:
            json.dump(cfg, f)
    for cell in CELLS:
        with open(os.path.join(root, "limits", f"{cell}.json"), "w") as f:
            json.dump(TINY_LIMITS, f)
    return root


def args(workload, seed=2147483659, seconds=0.0, trace=0):
    from fieldbench import run

    return run.parse(["--workload", workload, "--seed", str(seed), "--seconds", str(seconds),
                      "--trace", str(trace)])
