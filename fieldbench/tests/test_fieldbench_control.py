"""What decides ``correct``, held to its own promises on the CPU at tiny
sizes: the program passes; the control (the reference in the
configuration's lower precision, in the program's place) fails; and each
fault that a cell can have, planted under the timed path, turns
``correct`` false."""

from __future__ import annotations

import os

import pytest

from fieldbench import run
from fieldbench.harness import faults
from fieldbench.harness.control import control_step
from fieldbench.harness.drive import drive, verdict
from fieldbench.harness.spec import load_cell
from fieldbench.tests.tiny import CELLS, args, tiny_root


def _cell(tmp_path, workload):
    root = tiny_root(tmp_path)
    return load_cell(os.path.join(os.path.dirname(root), "BENCHMARK.json"), workload, root)


def _correct(numbers, cell):
    return all(numbers[k] <= v for k, v in cell.limits.items())


@pytest.mark.parametrize("workload", CELLS)
def test_the_control_fails_where_the_program_passes(tmp_path, workload):
    cell = _cell(tmp_path, workload)
    for seed in (11, 12):
        prog, _ = verdict(cell, drive(cell, seed, "cpu"), "cpu")
        ctrl, _ = verdict(cell, drive(cell, seed, "cpu", control_step), "cpu")
        assert _correct(prog, cell), prog
        assert not _correct(ctrl, cell), ctrl
        assert ctrl["apply_ratio"] > 3 * prog["apply_ratio"]


FAULTS = {  # fault -> the cells that can have it
    "state unchanged": CELLS,
    "answer altered": CELLS,
    "truncated": CELLS,
    "steepest descent": CELLS,
    "pull-back dropped": ("knot64_10240.cg", "knot64_10240.mgvi_short"),
    "half of the batch": ("exact_4096.mgvi", "knot64_10240.mgvi_short"),
}


def test_every_fault_is_planted_in_some_cell():
    assert set(FAULTS) == set(faults.FAULTS)


@pytest.mark.parametrize("fault, workload", [(f, w) for f, ws in FAULTS.items() for w in ws])
def test_a_fault_under_the_timed_path_is_not_correct(tmp_path, fault, workload):
    root = tiny_root(tmp_path)
    cell = load_cell(os.path.join(os.path.dirname(root), "BENCHMARK.json"), workload, root)
    with faults.planted(fault, cell.traffic["kind"]):
        result, _ = run.run(args(workload), "cpu", root=root)
    assert result["correct"] is False and result["failed"] == 1
