"""The work counts are frozen functions of a configuration's shapes and a
mix's settings: nothing else moves them, and they import nothing of the
program."""

from __future__ import annotations

import ast
import copy
import json
import math
import os

import pytest

from fieldbench import work
from fieldbench.tests.tiny import FIELDBENCH

CONFIGS = sorted(os.listdir(os.path.join(FIELDBENCH, "configs")))


def _load(kind, name):
    with open(os.path.join(FIELDBENCH, kind, name)) as f:
        return json.load(f)


@pytest.mark.parametrize("config", CONFIGS)
def test_counts_are_pure_functions_of_the_shapes_and_settings(config):
    cfg = _load("configs", config)
    mix = _load("traffic", "mgvi.json")
    counts = [work.apply_work(cfg["model"]), work.cg_iteration_work(cfg["model"]),
              work.hartley_work(cfg["model"]), work.pwl_apply_bytes(cfg["model"]),
              work.vi_iteration_work(cfg["model"], mix)]
    other = copy.deepcopy(cfg)
    other["source"], other["model"]["offset_mean"], other["model"]["fluctuations"] = "x", 7.0, [3.0, 1.0]
    assert counts == [work.apply_work(other["model"]), work.cg_iteration_work(other["model"]),
                      work.hartley_work(other["model"]), work.pwl_apply_bytes(other["model"]),
                      work.vi_iteration_work(other["model"], dict(mix, why="x", trace_steps=9))]
    n = cfg["model"]["grid_side"]
    assert work.hartley_work(cfg["model"]) == (8.0 * n * n, 2.5 * n * n * math.log2(n * n))
    bigger = dict(mix, draw_cg=mix["draw_cg"] + 1)
    assert work.vi_iteration_work(cfg["model"], bigger)[0] > counts[-1][0]


def test_work_imports_nothing_of_the_program():
    with open(os.path.join(FIELDBENCH, "work", "__init__.py")) as f:
        tree = ast.parse(f.read())
    names = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names}
    names |= {n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)}
    assert names <= {"__future__", "math"}
