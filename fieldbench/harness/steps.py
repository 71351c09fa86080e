"""The one generator of the window's work: a traffic mix's ``kind`` and
settings make the step that the window repeats, each step waiting for the
last (a closed loop of one fit).

- ``"cg"``: back-to-back solves of ``(M_p + 𝟙) x = b`` at the seed's
  position by the program's ``static_cg`` over its Hamiltonian metric,
  ``cg_iterations`` steps each (no stop on the residual), every solve a
  right-hand side of its own drawn from the seed.  Its work is counted in
  metric applies, as the solver makes them: one a CG iteration, and the
  residual's refreshes.
- ``"vi"``: ``OptimizeVI.update`` iterations from the seed's position,
  ``n_samples`` mirrored pairs (linear MGVI draws) resampled each
  iteration, the draw's static CG of ``draw_cg`` steps, the KL's one static
  Newton step of CG ``kl_cg``, the samples by ``vmap`` and the KL mapped
  as the mix's ``kl_map`` says.  Its work is counted in iterations.

Step 0 is the warm-up, part of set-up; the window runs steps 1, 2, ….
``checked`` is the step whose record is judged, drawn from the seed among
the first :data:`CHECK_AMONG` steps of the window.  ``work`` counts the
work a step object has done so far."""

from __future__ import annotations

import random

import torch

from .record import Recorder
from .system import System, draw_tree, generator

__all__ = ["CHECK_AMONG", "KL_NEWTON_STEPS", "CgSolves", "ViIterations", "make_step", "vi_keys"]

CHECK_AMONG = 3  # the checked step is one of the window's first three
KL_NEWTON_STEPS = 1  # the Newton steps of a KL minimisation, as the judge follows them


def _fixed(n):
    return dict(maxiter=n, miniter=n, resnorm=-1.0)


def checked_step(seed):
    return 1 + random.Random(int(seed)).randrange(CHECK_AMONG)


class CgSolves:
    kind = "cg"

    def __init__(self, system: System, traffic, seed, recorder: Recorder):
        nt = system.nt
        self.system, self.seed, self.recorder = system, seed, recorder
        self.iterations = int(traffic["cg_iterations"])
        self.work = 0  # metric applies made
        self.position = system.start
        self.ham = nt.StandardHamiltonian(system.likelihood)
        self.cg = recorder.wrap(nt.static_cg)

    def mat(self, t):
        self.work += 1
        return self.ham.metric(self.position, t)

    def rhs(self, i):
        return draw_tree(self.system.shapes, generator(self.system.device, self.seed, 100 + i))

    def __call__(self, i):
        res = self.cg(self.mat, self.rhs(i), **_fixed(self.iterations))
        return res.x


def vi_keys(device, seed, n_samples, step):
    """The sample keys of VI step ``step``: the program draws ``n_samples``
    a step from the generator the benchmark hands it; replayed here."""
    gen = generator(device, seed, 2)
    for _ in range(step + 1):
        keys = torch.randint(0, 2**62, (n_samples,), generator=gen, device=gen.device).tolist()
    return keys


class ViIterations:
    kind = "vi"

    def __init__(self, system: System, traffic, seed, recorder: Recorder):
        nt = system.nt
        self.system, self.recorder = system, recorder
        self.traffic = traffic
        self.work = 0  # iterations made
        cg = recorder.wrap(nt.static_cg)
        self.opt = nt.OptimizeVI(system.likelihood, 1 << 30, kl_map=traffic["kl_map"],
                                 residual_map="vmap")
        self.state = self.opt.init_state(
            generator(system.device, seed, 2),
            n_samples=int(traffic["n_samples"]),
            sample_mode="linear_resample",
            draw_linear_kwargs=dict(cg=cg, cg_kwargs=_fixed(int(traffic["draw_cg"]))),
            kl_kwargs=dict(minimize=nt.static_newton_cg, minimize_kwargs=dict(
                maxiter=KL_NEWTON_STEPS, cg=cg,
                cg_kwargs=_fixed(int(traffic["kl_cg"])))),
        )
        self.samples = nt.Samples(pos=system.start)
        # the draw's span and the KL's, which a traced run wraps
        self.draw_samples, self.kl_minimize = self.opt.draw_samples, self.opt.kl_minimize

    def __call__(self, i):
        keep = self.recorder.keep
        pos_in = keep(self.samples.pos)
        self.samples, self.state = self.opt.update(self.samples, self.state)
        self.work += 1
        out = {"pos_in": pos_in, "pos_out": keep(self.samples.pos), "samples": []}
        if self.recorder.mode is not None:
            out["samples"] = [keep(s) for s in self.samples]  # pos + each residual
        return out


def make_step(system, traffic, seed, recorder):
    kinds = {"cg": CgSolves, "vi": ViIterations}
    if traffic["kind"] not in kinds:
        raise ValueError(f"unknown traffic kind {traffic['kind']!r}; one of {sorted(kinds)}")
    return kinds[traffic["kind"]](system, traffic, seed, recorder)
