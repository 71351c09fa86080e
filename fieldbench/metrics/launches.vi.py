"""Device kernels launched a VI iteration in the traced iterations."""


def read(s):
    return s["launches"] / s["steps"] if s["launches"] else None
