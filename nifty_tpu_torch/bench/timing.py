"""Device time of a call on the card, without the host's dispatch in it,
and the least time the card could take for the same work."""

from __future__ import annotations

import math

__all__ = ["F32_FLOPS_PER_MS", "HBM_BYTES_PER_MS", "bound", "device_ms", "fft_flops"]

HBM_BYTES_PER_MS = 3.35e9  # H100 SXM: 3.35 TB/s
F32_FLOPS_PER_MS = 67e9  # H100 SXM: 67 TFLOP/s f32 outside the tensor cores


def bound(n_bytes, flops=0.0):
    """``(bound_ms, bound_by)``: the larger of bytes over the memory rate
    and flops over the f32 rate."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_MS, flops / F32_FLOPS_PER_MS
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def fft_flops(n, count):
    """5 n log2 n flops for each of ``count`` complex FFTs of length n."""
    return 5.0 * n * math.log2(n) * count


def device_ms(fn, iters=20, warmup=3):
    """Device time of one call of ``fn`` in ms: ``iters`` calls captured in
    one CUDA graph (after ``warmup`` calls outside it, which also build
    plans and caches), replayed between CUDA events."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / iters
