"""Device kernels launched a metric apply in the traced solves (the CG's
iterations and its residual's refresh, each one apply): what the host
pays to dispatch."""


def read(s):
    return s["launches"] / s["work"] if s["launches"] else None
