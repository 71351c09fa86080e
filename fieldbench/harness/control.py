"""The control: the reference in a lower precision put in the program's
place, driven by the same traffic and judged by the same numbers.

A cell's configuration names its control (``"control"``: ``"tf32"`` or
``"bfloat16"``, :class:`~fieldbench.reference.precision.Precision`).  Its
steps have the interface of :mod:`.steps`' and record through the same
:class:`~.record.Recorder`, so :mod:`.judge` reads them as it reads the
program's."""

from __future__ import annotations

from types import SimpleNamespace

from ..reference.field import Field
from ..reference.inference import Posterior, cg
from ..reference.precision import Precision
from .steps import vi_keys
from .system import Inputs, draw_tree, generator

__all__ = ["control_step"]


def _solver(prec):
    """The reference's CG with the program solver's call signature."""

    def solve(mat, j, x0=None, *, batched=False, maxiter, **kw):
        return SimpleNamespace(x=cg(mat, j, x0, maxiter, prec.store))

    return solve


class ControlCg:
    kind = "cg"

    def __init__(self, inputs: Inputs, traffic, seed, recorder, prec):
        self.inputs, self.seed = inputs, seed
        self.iterations = int(traffic["cg_iterations"])
        self.work = 0
        post = Posterior(Field(inputs.config["model"], inputs.device, prec), inputs.data)
        self.position = inputs.start
        self.metric = post.metric_at(post.cast(self.position))
        self.cg = recorder.wrap(_solver(prec))

    def mat(self, t):
        self.work += 1
        return self.metric(t)

    def rhs(self, i):
        return draw_tree(self.inputs.shapes, generator(self.inputs.device, self.seed, 100 + i))

    def __call__(self, i):
        return self.cg(self.mat, self.rhs(i), maxiter=self.iterations).x


class ControlVi:
    kind = "vi"

    def __init__(self, inputs: Inputs, traffic, seed, recorder, prec):
        self.inputs, self.seed, self.traffic, self.recorder = inputs, seed, traffic, recorder
        self.work = 0
        self.post = Posterior(Field(inputs.config["model"], inputs.device, prec), inputs.data)
        solve = recorder.wrap(_solver(prec))
        self.post.solve = lambda mat, j, x0, iterations: solve(mat, j, x0, maxiter=iterations).x
        self.pos = self.post.cast(inputs.start)

    def __call__(self, i):
        keep, t = self.recorder.keep, self.traffic
        keys = vi_keys(self.inputs.device, self.seed, int(t["n_samples"]), i)
        pos_in = keep(self.pos)
        residuals, self.pos, _ = self.post.mgvi_iteration(self.pos, keys, int(t["draw_cg"]),
                                                          int(t["kl_cg"]))
        self.work += 1
        out = {"pos_in": pos_in, "pos_out": keep(self.pos), "samples": []}
        if self.recorder.mode is not None:
            out["samples"] = [keep({k: v + r[k] for k, v in self.pos.items()}) for r in residuals]
        return out


def control_step(inputs, traffic, seed, recorder):
    """The control's step for the cell of ``inputs``' configuration."""
    prec = Precision(inputs.config["control"])
    kinds = {"cg": ControlCg, "vi": ControlVi}
    return kinds[traffic["kind"]](inputs, traffic, seed, recorder, prec)

