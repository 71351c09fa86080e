"""A cell as ``BENCHMARK.json`` names it, and the files of its own that the
harness finds by those names:

- ``configs/<config>.json``: the model, its grid and form, the likelihood,
  the precision it states and its control's, ``source``, ``reduced``,
  ``assumed`` and the deployment;
- ``traffic/<traffic>.json``: the step the window repeats (``kind``) and
  its fixed settings, read by the one generator of :mod:`.steps`;
- ``limits/<workload>.json``: the limit of each number the check compares;
- ``metrics/<metric>.py``: a reader of a per-layer metric, with a function
  ``read(summary)`` that returns its value or None.

A later cell, mix or metric is new files and new entries in
``BENCHMARK.json``: nothing here changes."""

from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass

__all__ = ["Cell", "ROOT", "load_cell", "read_json"]

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))  # fieldbench/


def read_json(path):
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list  # the BENCHMARK.json entries this cell reports
    per_layer: list
    readers: dict  # per-layer metric name -> read(summary)


def _reader(root, name):
    path = os.path.join(root, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"fieldbench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _reports(metric, cell):
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(benchmark_path, workload, root=ROOT):
    """The cell ``workload`` of the benchmark file ``benchmark_path``, its
    files looked up under ``root``."""
    bench = read_json(benchmark_path)
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in {benchmark_path}; one of {sorted(cells)}")
    w = cells[workload]
    e2e = [m for m in bench["end_to_end"] if _reports(m, workload)]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"] if _reports(m, workload) and m["moves"] in names]
    return Cell(
        name=workload,
        chips=int(w["chips"]),
        config=read_json(os.path.join(root, "configs", f"{w['config']}.json")),
        traffic=read_json(os.path.join(root, "traffic", f"{w['traffic']}.json")),
        limits=read_json(os.path.join(root, "limits", f"{workload}.json")),
        end_to_end=e2e,
        per_layer=layer,
        readers={m["name"]: _reader(root, m["name"]) for m in layer},
    )
