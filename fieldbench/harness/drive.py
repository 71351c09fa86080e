"""One run of a cell: set-up, the warm-up, the measured window, the traced
steps, then the judge, for the program or for the control in its place."""

from __future__ import annotations

import gc
import time
import traceback
from types import SimpleNamespace

import torch

from . import judge as judging
from .record import Recorder
from .steps import checked_step, make_step, vi_keys
from .system import Inputs, System

__all__ = ["drive", "program_step", "verdict"]


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def program_step(inputs, traffic, seed, recorder):
    """The program's step: the port's system built from the inputs."""
    return make_step(System(inputs), traffic, seed, recorder)


def _one(step, i, checked, recorder, device):
    if i == checked:
        recorder.arm("record")
    result = step(i)
    sync(device)
    if i == checked:
        recorder.disarm()
    return result


def drive(cell, seed, device, make=program_step, seconds=0.0, trace=False, t0=None):
    """Set up the cell's step from ``make``, warm it up, run the window of
    ``seconds`` (at least one step), then the checked step if it was not
    reached, and with ``trace`` the traffic's ``trace_steps`` under the
    profiler.  Returns the run's readings and what the judge needs."""
    t0 = time.perf_counter() if t0 is None else t0
    device = torch.device(device)
    traffic = cell.traffic
    inputs = Inputs(cell.config, seed, device, traffic.get("start", "draw"))
    recorder = Recorder()
    step = make(inputs, traffic, seed, recorder)
    checked = checked_step(seed)
    recorder.arm("measure")
    step(0)  # the warm-up: every shape the window uses
    sync(device)
    recorder.disarm()
    recorder.allocate(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.perf_counter() - t0

    out, i, work0 = None, 1, step.work
    t_start = time.perf_counter()
    while True:
        result = _one(step, i, checked, recorder, device)
        out = result if i == checked else out
        i += 1
        if time.perf_counter() - t_start >= seconds:
            break
    window_s, n_steps, work = time.perf_counter() - t_start, i - 1, step.work - work0
    while out is None:  # the checked step is due: wait for it past the window
        result = _one(step, i, checked, recorder, device)
        out = result if i == checked else out
        i += 1
    peak = torch.cuda.max_memory_allocated(device) - recorder.pool_bytes if device.type == "cuda" else 0
    run = SimpleNamespace(setup_s=setup_s, window_s=window_s, n_steps=n_steps,
                          work=work, peak=peak, summary=None)
    if trace:
        from . import trace as tracing

        traced, work0 = int(traffic["trace_steps"]), step.work
        with tracing.spans(step) as host, torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]) as prof:
            for k in range(traced):
                with torch.profiler.record_function(tracing.STEP):
                    step(i + k)
                sync(device)
        t_sum = time.perf_counter()
        run.summary = tracing.summarize(prof, host)
        del prof
        run.summary["summarize_s"] = time.perf_counter() - t_sum
        run.summary.update(config=cell.config, traffic=traffic, steps=traced,
                           work=step.work - work0, step_s=window_s / n_steps,
                           peak_bytes=peak)
    if step.kind == "cg":
        run.extra = dict(position=step.position, rhs=step.rhs(checked))
    else:
        run.extra = dict(keys=vi_keys(device, seed, int(traffic["n_samples"]), checked))
    run.data, run.log, run.out, run.recorder = inputs.data, recorder.log, out, recorder
    return run


def verdict(cell, run, device):
    """``(numbers, stages)``: the judge's reading of the run's checked step,
    NaN where the reference cannot read the record.  Frees what the run
    holds but the record first."""
    device = torch.device(device)
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    try:
        return judging.judge(cell.config, cell.traffic, run.data, device, run.log, run.out,
                             **run.extra)
    except Exception:  # a record the reference cannot read is no correct answer
        traceback.print_exc()
        return {k: float("nan") for k in cell.limits}, {}
