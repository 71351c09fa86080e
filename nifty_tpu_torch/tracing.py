"""Spans and counters of the port: the one home of its instrumentation.

A span marks a layer of the program on ``torch.profiler``'s timeline, on
the clock of the CUDA kernels it launches, so that a trace names what the
host was doing while the card ran or stood idle::

    with tracing.span("cg"):
        ...

    @tracing.span("vi.update")
    def update(...):
        ...

While a profiler records, a span opens a range named ``"nt." + name``
on the host's timeline; otherwise it costs one check of a Python flag and
returns a shared no-op.  Tracing is on exactly while someone profiles;
there is no switch.  A span never synchronises, never launches a kernel
and never reads a tensor.  Its range is an ordinary host range, not a
user annotation (``is_user_annotation`` is false): the profiler puts the
kernels launched inside it under it (``device_time_total``) but draws no
range of its own on the device's timeline, so a trace's device events
stay kernels.

The counters always count, an integer add at the site (:func:`count`):

- :data:`counts`: ``host_reads`` (blocking reads of a device value on the
  solvers' and samplers' path, each through :func:`host_read`),
  ``pwl_passes`` (passes of the knot form's relu-feature map, either
  direction) and ``taps_cut`` (the sharded NUFFT's tap matrices cut,
  read through ``parallel.nufft.taps_cut``);
- :data:`profiled`: the same counts, made while a profiler records, so
  that a profiled stretch of a run reads its own counts;
- :data:`launches`: launches of the hand-written kernels by wrapper name,
  added where a wrapper launches its kernel on the card;
  :data:`batched_launches`: those of them that took a batch of more than
  one sample.

Read a counter's difference over the work of interest, or clear it first.
"""

from __future__ import annotations

import collections
import functools

import torch
from torch._C._profiler import _RecordFunctionFast as _Range
from torch.autograd import profiler as _profiler

__all__ = [
    "PREFIX",
    "batched_launches",
    "count",
    "counts",
    "host_read",
    "launches",
    "profiled",
    "reset_launches",
    "span",
]

PREFIX = "nt."

counts: collections.Counter = collections.Counter()
profiled: collections.Counter = collections.Counter()
launches: collections.Counter = collections.Counter()
batched_launches: collections.Counter = collections.Counter()


def reset_launches() -> None:
    """Set every launch count to 0."""
    launches.clear()
    batched_launches.clear()


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` (and to its profiled count while a
    profiler records)."""
    counts[name] += n
    if _profiler._is_profiler_enabled:
        profiled[name] += n


def _decorate(name, fn):
    @functools.wraps(fn)
    def spanned(*args, **kwargs):
        with span(name):
            return fn(*args, **kwargs)

    return spanned


class _Off:
    """A span while no profiler records; as a decorator, a span opened at
    each call."""

    __slots__ = ("name",)

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False

    def __call__(self, fn):
        return _decorate(self.name, fn)


class _On:
    """A span while a profiler records: a host range of the function scope
    (a user annotation would be drawn on the device's timeline too); as a
    decorator, a span opened at each call."""

    __slots__ = ("name", "_range")

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        self._range = _Range(PREFIX + self.name)
        self._range.__enter__()

    def __exit__(self, *exc):
        self._range.__exit__(*exc)
        return False

    def __call__(self, fn):
        return _decorate(self.name, fn)


_OFF: dict = {}


def span(name: str):
    """The span ``"nt." + name``: a context manager, or a decorator that
    opens it around each call."""
    # read through the module: the profiler rebinds the flag on start and stop
    if _profiler._is_profiler_enabled:
        return _On(name)
    off = _OFF.get(name)
    if off is None:
        off = _OFF.setdefault(name, _Off(name))
    return off


def host_read(t: torch.Tensor):
    """``t``'s value on the host (a Python number, bool or list), inside
    the ``host_read`` span: a blocking read of a device value, counted in
    ``counts["host_reads"]``."""
    count("host_reads")
    with span("host_read"):
        return t.tolist()
