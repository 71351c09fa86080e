"""Passes of the knot form's relu-feature map (either direction) a metric
apply: the program's ``pwl_passes`` counter as counted while the profiler
recorded (the traced solves alone), over the applies they made.  A
program without the counter reads nothing."""


def read(s):
    try:
        from nifty_tpu_torch import tracing
    except ImportError:
        return None
    n = tracing.profiled.get("pwl_passes")
    return n / s["work"] if n and s["work"] else None
