"""Profiling: the times of a function's forward, JVP and VJP, and a call
counter (counterpart of ``nifty_tpu/profiling.py``).

On the card a time is read from CUDA events around the call, on the CPU
from ``time.perf_counter``.  The JAX package's ``cost_analysis`` reads
XLA's cost model and has no counterpart here: ``bench/metric_profile.py``
sums the device time of a metric apply by kernel from the profiler.
"""

from __future__ import annotations

import time
from typing import Callable

import numpy as np
import torch
from torch.autograd import forward_ad
from torch.utils._pytree import tree_leaves

from .logger import logger
from .utils.tree import ones_like

__all__ = ["CountingCall", "exec_time"]


def device_of(tree) -> torch.device:
    """The device of the first tensor leaf of ``tree`` (the CPU without one)."""
    for x in tree_leaves(tree):
        if isinstance(x, torch.Tensor):
            return x.device
    return torch.device("cpu")


def call_seconds(f: Callable, device: torch.device) -> float:
    """Seconds of one call of ``f``: between CUDA events on the card (the
    device's time, the host's dispatch in it), by the host's clock on the
    CPU."""
    if device.type != "cuda":
        t0 = time.perf_counter()
        f()
        return time.perf_counter() - t0
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    f()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3


def _median_seconds(f, device, n):
    f()  # warm-up
    return float(np.median([call_seconds(f, device) for _ in range(n)]))


def exec_time(fn: Callable, primals, *, n: int = 3, verbose: bool = True):
    """Median seconds of ``n`` calls each of ``fn``'s forward, JVP (tangent
    all ones) and VJP (cotangent all ones), after one call each; ``compile``
    is the first forward call's seconds (eager: its first-use costs, such as
    building the kernels).  Returns ``{"compile", "forward", "jvp",
    "vjp"}``."""
    dev = device_of(primals)
    compile_s = call_seconds(lambda: fn(primals), dev)
    tangent = ones_like(primals)
    cotangent = ones_like(fn(primals))
    res = {
        "compile": compile_s,
        "forward": _median_seconds(lambda: fn(primals), dev, n),
        "jvp": _median_seconds(lambda: torch.func.jvp(fn, (primals,), (tangent,))[1], dev, n),
        "vjp": _median_seconds(lambda: torch.func.vjp(fn, primals)[1](cotangent), dev, n),
    }
    if verbose:
        logger.info(
            "exec_time: compile %.3fs | forward %.3es | jvp %.3es | vjp %.3es"
            % (res["compile"], res["forward"], res["jvp"], res["vjp"])
        )
    return res


class CountingCall:
    """A callable that counts its calls: ``n_jvp`` those inside
    ``torch.func.jvp`` (an input carries a forward-mode tangent at the
    current level: ``forward_ad.unpack_dual(x).tangent`` is set) and
    ``n_apply`` the others.  A reverse-mode pass calls the function as a
    plain forward, so ``n_vjp`` stays 0, as in the JAX package."""

    def __init__(self, fn: Callable, name: str = "op"):
        self.fn = fn
        self.name = name
        self.n_apply = 0
        self.n_jvp = 0
        self.n_vjp = 0

    def __call__(self, x, *args, **kwargs):
        leaves = [t for t in tree_leaves(x) if isinstance(t, torch.Tensor)]
        if any(forward_ad.unpack_dual(t).tangent is not None for t in leaves):
            self.n_jvp += 1
        else:
            self.n_apply += 1
        return self.fn(x, *args, **kwargs)

    def reset(self):
        self.n_apply = self.n_jvp = self.n_vjp = 0

    def report(self) -> str:
        return f"CountingCall({self.name}): apply={self.n_apply} jvp={self.n_jvp}"

    def __repr__(self):
        return self.report()
