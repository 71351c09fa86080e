"""The whole step's share of the card's roofline, in %: the least time a
CG iteration's needed work takes at the H100's peaks
(:mod:`fieldbench.work`), over the untraced window's time a CG iteration."""

from fieldbench import work


def read(s):
    if not s["launches"]:
        return None
    per_iteration = s["step_s"] / int(s["traffic"]["cg_iterations"])
    return 100.0 * work.bound_s(*work.cg_iteration_work(s["config"]["model"])) / per_iteration
