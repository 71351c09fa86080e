"""The knot form's relu-feature map against its roofline, in %: the bytes
it needs over the traced applies (:func:`fieldbench.work.pwl_apply_bytes`)
at the H100's memory rate, over the device time of the kernels launched
inside the benchmark's range around ``ops.pwl.pwl_features`` and
``pwl_transpose``."""

from fieldbench import work


def read(s):
    if not s["pwl_device_s"]:
        return None
    need = work.pwl_apply_bytes(s["config"]["model"]) * s["work"] / work.HBM_BYTES_PER_S
    return 100.0 * need / s["pwl_device_s"]
