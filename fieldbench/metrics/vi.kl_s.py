"""Host seconds of an iteration's ``OptimizeVI.kl_minimize`` span,
synchronised at its ends, averaged over the traced iterations."""


def read(s):
    t = s["host_spans"].get("kl_minimize")
    return sum(t) / len(t) if t else None
