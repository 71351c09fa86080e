"""Times and memory of a model's forward, JVP and VJP (counterpart of
``nifty_tpu/check_model.py``).

For each mode the report holds the eager wall time of a call and, on the
card, the device time of a call between CUDA events and the peak of
allocated memory over it; these take the place of the JAX package's
``jit`` time and XLA's ``memory_analysis``.  XLA's inlined HLO constants
(``parse_hlo_constants``) have no counterpart in an eager program.  The
listing of the model's leaves becomes its parameters and buffers.
"""

from __future__ import annotations

import itertools
from timeit import Timer

import numpy as np
import torch

from .logger import logger
from .profiling import call_seconds, device_of
from .utils.tree import ones_like

__all__ = ["check_model"]

DEVICE_CALLS = 5


def _wall_seconds(f, device):
    """Seconds a call by ``timeit``'s autorange, each call synchronised."""

    def call():
        f()
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    call()  # warm-up
    n, total = Timer(call).autorange()
    return total / n


def check_model(model, pos, *, log=None):
    """Time ``model``'s forward, JVP (tangent ``pos``) and VJP (cotangent
    all ones) at ``pos``.

    Returns ``{mode: {"time_raw", "device_ms", "peak_bytes"}}`` for the
    modes ``forward``, ``jvp`` and ``vjp``: the eager wall seconds of a
    call, and on the card the median device ms of :data:`DEVICE_CALLS`
    calls and the peak bytes allocated during one (None on the CPU).  Logs a summary, and the
    model's parameters and buffers."""
    log = logger.info if log is None else log
    dev = device_of(pos)
    cotangent = ones_like(model(pos))
    modes = {
        "forward": lambda: model(pos),
        "jvp": lambda: torch.func.jvp(model, (pos,), (pos,)),
        "vjp": lambda: torch.func.vjp(model, pos)[1](cotangent),
    }
    report = {}
    for name, fn in modes.items():
        entry = {"time_raw": _wall_seconds(fn, dev), "device_ms": None, "peak_bytes": None}
        msg = f"=== {name} ===\n  * time (eager): {entry['time_raw']:.1e}s\n"
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
            fn()
            torch.cuda.synchronize(dev)
            entry["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
            entry["device_ms"] = 1e3 * float(np.median([call_seconds(fn, dev) for _ in range(DEVICE_CALLS)]))
            msg += (f"  * device time: {entry['device_ms']:.3e} ms\n"
                    f"  * peak memory: {entry['peak_bytes']} B\n")
        report[name] = entry
        log(msg)

    msg = "model parameters and buffers:\n"
    if isinstance(model, torch.nn.Module):
        for name, t in itertools.chain(model.named_parameters(), model.named_buffers()):
            msg += f"  * {name}: shape {tuple(t.shape)} dtype {t.dtype} on {t.device}\n"
    else:
        msg += f"  * a {type(model).__name__}, not a torch.nn.Module: none\n"
    log(msg)
    return report
