"""Share of the traced iterations' window with no kernel on the card, in %."""


def read(s):
    return 100.0 * (1.0 - s["busy_s"] / s["window_s"]) if s["launches"] else None
