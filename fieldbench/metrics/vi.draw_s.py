"""Host seconds of an iteration's ``OptimizeVI.draw_samples`` span,
synchronised at its ends, averaged over the traced iterations."""


def read(s):
    t = s["host_spans"].get("draw_samples")
    return sum(t) / len(t) if t else None
