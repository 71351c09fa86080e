"""The program's counters in a traced line, on the CPU at tiny sizes: the
tiny cells' ``--trace 1`` lines carry ``pwl_passes.cg`` and
``host_reads.vi``, and a program without the counters reads nothing."""

from __future__ import annotations

import json
import sys

import pytest

from fieldbench import run
from fieldbench.harness.spec import ROOT, _reader
from fieldbench.tests.tiny import args, tiny_root

COUNTED = [("knot64_10240.cg", "pwl_passes.cg", 4.0),  # jvp primal and tangent, vjp, pull-back
           ("knot64_10240.mgvi_short", "host_reads.vi", 4.0)]  # the seeds' list, three Newton flags


@pytest.mark.parametrize("workload, metric, value", COUNTED, ids=[c[1] for c in COUNTED])
def test_a_traced_line_carries_the_program_counters(tmp_path, workload, metric, value):
    from nifty_tpu_torch import tracing

    tracing.profiled.clear()  # a run's process profiles once; this one may have profiled before
    result, _ = run.run(args(workload, seconds=0.2, trace=1), "cpu", root=tiny_root(tmp_path))
    line = json.loads(json.dumps(result))
    assert line["metrics"][metric]["value"] == value


@pytest.mark.parametrize("metric", [c[1] for c in COUNTED])
def test_a_program_without_counters_reads_nothing(monkeypatch, metric):
    import nifty_tpu_torch

    # a port older than the counters has no such module: its import fails
    monkeypatch.delattr(nifty_tpu_torch, "tracing")
    monkeypatch.setitem(sys.modules, "nifty_tpu_torch.tracing", None)
    assert _reader(ROOT, metric)({"work": 21, "steps": 1}) is None
