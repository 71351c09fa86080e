"""The whole step's share of the card's roofline, in %: the least time an
MGVI iteration's needed work takes at the H100's peaks
(:mod:`fieldbench.work`), over the untraced window's time an iteration."""

from fieldbench import work


def read(s):
    if not s["launches"]:
        return None
    need = work.bound_s(*work.vi_iteration_work(s["config"]["model"], s["traffic"]))
    return 100.0 * need / s["step_s"]
