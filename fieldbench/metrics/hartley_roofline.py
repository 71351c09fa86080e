"""K3 + K4, the 2-D Hartley transform, against its roofline, in %: the
transforms launched (one K3 launch each, a batch of one) times the least
time of one transform (:func:`fieldbench.work.hartley_work`), over the
device time of the K3 and K4 kernels."""

from fieldbench import work


def read(s):
    k3 = [(c, t) for n, (c, t) in s["kernels"].items() if "hartley_rows" in n]
    k4 = [t for n, (c, t) in s["kernels"].items() if "hartley_cols" in n]
    seconds = sum(t for _, t in k3) + sum(k4)
    if not k3 or not seconds:
        return None
    need = sum(c for c, _ in k3) * work.bound_s(*work.hartley_work(s["config"]["model"]))
    return 100.0 * need / seconds
