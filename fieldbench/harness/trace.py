"""The traced run: a few steps under ``torch.profiler``, reduced in memory to
a summary that the per-layer readers take.

The spans are the benchmark's own profiler ranges, opened around calls
into the program's layers (nothing in the program is edited):
``fieldbench.step`` around each step, ``fieldbench.draw_samples`` and
``fieldbench.kl_minimize`` around an ``OptimizeVI``'s two halves (timed on
the host between synchronisations as well), and ``fieldbench.pwl`` around
the knot form's relu-feature map, ``ops.pwl.pwl_features`` and
``pwl_transpose``.  Kernels are classed by name (:data:`KINDS`, as the
port's ``bench/metric_profile.py`` classes them)."""

from __future__ import annotations

import contextlib
import time

import torch

__all__ = ["KINDS", "kind_of", "spans", "summarize"]

KINDS = (  # (kind, substrings of the kernel name), first match wins
    ("gather", ("vectorized_gather", "index_elementwise", "indexSelect", "index_copy")),
    ("K1 expand", ("expand_rfp2", "expand_flat", "gather_kernel")),
    ("K2 collapse", ("collapse_fold", "segsum")),
    ("K3 hartley_rows", ("hartley_rows",)),
    ("K4 hartley_cols", ("hartley_cols",)),
    ("K7 philox_normal", ("philox",)),
    ("copy", ("copy_kernel",)),
    ("gemv/gemm", ("gemv", "gemm", "gemmk", "splitKreduce")),
    ("elementwise", ("elementwise", "vectorized", "unrolled")),
    ("cat", ("CatArray", "cat_")),
    ("reductions", ("reduce", "Reduce", "scan", "Scan")),
)
PWL = "fieldbench.pwl"
STEP = "fieldbench.step"


def sync():
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def kind_of(name):
    for kind, keys in KINDS:
        if any(k in name for k in keys):
            return kind
    return "other"


class HostSpans:
    """Host seconds of the spans that a step opens, synchronised at their
    ends, a list a span."""

    def __init__(self):
        self.seconds = {}

    def wrap(self, name, fn):
        def spanned(*args, **kwargs):
            sync()
            t0 = time.perf_counter()
            with torch.profiler.record_function(f"fieldbench.{name}"):
                out = fn(*args, **kwargs)
            sync()
            self.seconds.setdefault(name, []).append(time.perf_counter() - t0)
            return out

        return spanned


@contextlib.contextmanager
def spans(step):
    """Open the benchmark's spans around ``step``'s layers while tracing."""
    from nifty_tpu_torch.ops import pwl

    host = HostSpans()
    saved = pwl.pwl_features, pwl.pwl_transpose

    def ranged(fn):
        def call(*args):
            with torch.profiler.record_function(PWL):
                return fn(*args)

        return call

    pwl.pwl_features, pwl.pwl_transpose = ranged(saved[0]), ranged(saved[1])
    opt = getattr(step, "opt", None)
    if opt is not None:
        opt.draw_samples = host.wrap("draw_samples", step.draw_samples)
        opt.kl_minimize = host.wrap("kl_minimize", step.kl_minimize)
    try:
        yield host
    finally:
        pwl.pwl_features, pwl.pwl_transpose = saved
        if opt is not None:
            del opt.draw_samples, opt.kl_minimize


def _union(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def summarize(prof, host, top=10):
    """The traced window's summary: kernel launches and device seconds by
    kind and name, the device's busy seconds (the union of kernel
    intervals), the pwl range's device seconds, the idle seconds by the
    innermost benchmark span open on the host when each gap began, and the
    host spans' seconds.  The window runs from the first traced step's
    start to the last one's end."""
    cuda = torch.autograd.DeviceType.CUDA
    kernels, ranges, pwl_s = [], [], 0.0
    for ev in prof.events():
        if ev.device_type == cuda:
            if not ev.name.startswith("fieldbench."):
                kernels.append((ev.time_range.start, ev.time_range.end, ev.name))
        elif ev.name.startswith("fieldbench."):
            ranges.append((ev.time_range.start, ev.time_range.end, ev.name[len("fieldbench."):]))
            if ev.name == PWL:
                pwl_s += ev.device_time_total * 1e-6
    steps = [r for r in ranges if r[2] == "step"]
    lo, hi = min(r[0] for r in steps), max(r[1] for r in steps)
    by_name = {}
    for a, b, name in kernels:
        d = by_name.setdefault(name, [0, 0.0])
        d[0] += 1
        d[1] += (b - a) * 1e-6
    busy = _union([(max(a, lo), min(b, hi)) for a, b, _ in kernels if b > lo and a < hi])
    busy_s = sum(b - a for a, b in busy) * 1e-6
    gaps, edge = {}, lo
    for a, b in busy + [[hi, hi]]:
        if a > edge:
            inner = [r for r in ranges if r[0] <= edge < r[1]]
            name = min(inner, key=lambda r: r[1] - r[0])[2] if inner else "outside the steps"
            gaps[name] = gaps.get(name, 0.0) + (a - edge) * 1e-6
        edge = max(edge, b)
    kinds = {}
    for name, (count, s) in by_name.items():
        d = kinds.setdefault(kind_of(name), [0, 0.0])
        d[0] += count
        d[1] += s
    return {
        "window_s": (hi - lo) * 1e-6,
        "busy_s": busy_s,
        "launches": sum(c for c, _ in by_name.values()),
        "kernels": by_name,
        "kinds": kinds,
        "pwl_device_s": pwl_s,
        "host_spans": host.seconds,
        "breakdown": {
            "device_ops": [[f"{kind_of(n)}: {n[:120]}", s] for n, (_, s) in
                           sorted(by_name.items(), key=lambda kv: -kv[1][1])[:top]],
            "idle_gaps": [[n, s] for n, s in sorted(gaps.items(), key=lambda kv: -kv[1])[:top]],
        },
    }
