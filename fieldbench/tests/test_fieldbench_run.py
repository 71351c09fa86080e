"""The harness end to end on the CPU at tiny sizes: each cell's last line,
a mix added by files alone, the refusal without a card, the import rule,
and the card-only run."""

from __future__ import annotations

import ast
import hashlib
import json
import os
import subprocess
import sys

import pytest

from fieldbench import run
from fieldbench.tests.tiny import CELLS, FIELDBENCH, args, tiny_root

REPO = os.path.dirname(FIELDBENCH)


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("workload", CELLS)
def test_cell_prints_a_well_formed_line(tmp_path, workload, trace):
    root = tiny_root(tmp_path)
    result, lines = run.run(args(workload, seconds=0.2, trace=trace), "cpu", root=root)
    line = json.loads(json.dumps(result))
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "check"
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] >= 1
    with open(os.path.join(str(tmp_path), "BENCHMARK.json")) as f:
        bench = json.load(f)
    e2e = {m["name"] for m in bench["end_to_end"] if workload in m.get("workloads", [workload])}
    if trace:
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        layer = {m["name"] for m in bench["per_layer"] if workload in m["workloads"]}
        # the CPU has no device trace: only the host spans can be read
        assert set(line["metrics"]) <= layer
    else:
        assert set(line["metrics"]) == e2e and "setup_s" in e2e
        assert all(v["value"] > 0 for v in line["metrics"].values())
    assert lines[-len(line["check"]):] == [
        f"check {k}: {v['value']!r} limit {v['limit']!r}" for k, v in line["check"].items()]


def _digest(root):
    out = {}
    for d, _, files in os.walk(root):
        for name in files:
            if "__pycache__" not in d:
                with open(os.path.join(d, name), "rb") as f:
                    out[os.path.relpath(os.path.join(d, name), root)] = hashlib.sha1(f.read()).hexdigest()
    return out


def test_a_mix_is_added_by_files_alone(tmp_path):
    root = tiny_root(tmp_path)
    before = _digest(root)
    with open(os.path.join(root, "traffic", "cg_short.json"), "w") as f:
        json.dump({"kind": "cg", "cg_iterations": 5, "trace_steps": 1}, f)
    with open(os.path.join(root, "limits", "exact_4096.cg_short.json"), "w") as f:
        json.dump({"apply_ratio": 25.0, "direction_gap": 5e-3, "cg_iterations_off": 0.0,
                   "state_gap": 1e-2}, f)
    bench_path = os.path.join(str(tmp_path), "BENCHMARK.json")
    with open(bench_path) as f:
        bench = json.load(f)
    bench["workloads"].append({"name": "exact_4096.cg_short", "config": "cf_poisson_exact_4096",
                               "traffic": "cg_short", "chips": 1, "why": "a test mix"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "knot64_10240.cg" in m.get("workloads", ()) and m["name"] not in (
                "pwl_roofline", "hartley_roofline"):
            m["workloads"].append("exact_4096.cg_short")
    with open(bench_path, "w") as f:
        json.dump(bench, f)
    after = _digest(root)
    assert {k: v for k, v in after.items() if k in before} == before  # nothing edited
    result, _ = run.run(args("exact_4096.cg_short", seconds=0.1), "cpu", root=root)
    assert result["correct"] and set(result["metrics"]) == {"metric_apply_ms", "setup_s"}


def test_no_card_no_result():
    proc = subprocess.run([sys.executable, os.path.join(FIELDBENCH, "run.py"), "--workload",
                           CELLS[0], "--seed", "1", "--seconds", "1", "--trace", "0"],
                          capture_output=True, text=True, cwd=REPO, timeout=300,
                          env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "CUDA card" in proc.stderr


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_nothing_imports_jax_or_the_jax_package():
    bad = set(run.FORBIDDEN)
    found = {}
    for d, _, files in os.walk(FIELDBENCH):
        for name in files:
            if name.endswith(".py"):
                path = os.path.join(d, name)
                tops = {m.split(".", 1)[0] for m in _imports(path)}
                if tops & bad:
                    found[path] = tops & bad
                if "/reference/" in path:
                    assert "nifty_tpu_torch" not in tops, path
    assert not found


@pytest.mark.parametrize("modules, found", [
    (["nifty_tpu_torch", "nifty_tpu_torch.ops.fft", "torch"], []),
    (["jaxtyping", "flaxen", "nifty_tpu_torchx"], []),
    (["nifty_tpu.ops"], ["nifty_tpu"]),
    (["jax._src.api", "jaxlib"], ["jax", "jaxlib"]),
    (["flax.linen"], ["flax"]),
])
def test_forbidden_modules_by_whole_top_level_name(modules, found):
    assert run.forbidden_modules(modules) == found


@pytest.mark.cuda
def test_a_cell_on_the_card(tmp_path):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    root = tiny_root(tmp_path, side=256, knots=8)
    result, _ = run.run(args("knot64_10240.cg", seconds=0.5, trace=1), "cuda", root=root)
    assert result["correct"] and result["device"]["platform"] == "gpu"
    assert result["device"]["busy_s"] > 0
