"""The system under test, built from a configuration through the port's
public API, and the inputs the benchmark makes from the seed.

The model is the upstream JOSS benchmark's: ``CorrelatedFieldMaker`` with a
total offset and one fluctuation term on an n × n grid of spacing 1/n,
under ``Poissonian`` through ``exp`` (the construction follows the port's
``bench/workload.py:bench_field``).  Inputs are made on the device from a
``torch.Generator`` seeded by the run's seed, key by key in sorted order:
the latent that draws the counts, then the starting position (or, where the
mix says so, the start is that latent).  The counts are Poisson at the rate
that the reference field gives that latent, so nothing the program computes
goes into them."""

from __future__ import annotations

import torch

from ..reference.field import Field
from ..reference.precision import Precision

__all__ = ["Inputs", "System", "draw_tree", "generator"]

_MASK63 = (1 << 63) - 1


def generator(device, seed, stream=0):
    """A generator on ``device`` for the seed's input ``stream``."""
    return torch.Generator(device=device).manual_seed((int(seed) * 1_000_003 + stream) & _MASK63)


def draw_tree(shapes, gen, dtype=torch.float32):
    """Standard normals of ``shapes`` (a dict), key by key in sorted order."""
    return {k: torch.randn(shapes[k], generator=gen, device=gen.device, dtype=dtype)
            for k in sorted(shapes)}


class Inputs:
    """The seed's counts and starting position for configuration
    ``config`` on ``device``, shaped by the reference's domain.  ``start``
    is ``"draw"`` (a latent of its own, drawn from the seed) or ``"truth"``
    (the latent that drew the counts)."""

    def __init__(self, config, seed, device, start="draw"):
        self.config, self.seed, self.device = config, seed, torch.device(device)
        ref = Field(config["model"], self.device, Precision("float64"))
        self.shapes = ref.domain()
        dtype = getattr(torch, config["dtype"])
        gen = generator(self.device, seed, 0)
        truth = draw_tree(self.shapes, gen)
        with torch.no_grad():
            rate = torch.exp(ref.forward({k: v.double() for k, v in truth.items()})).clamp_max(1e6)
        del ref
        self.data = torch.poisson(rate, generator=gen).to(torch.int32)
        del rate
        if start not in ("draw", "truth"):
            raise ValueError(f"unknown start {start!r}; 'draw' or 'truth'")
        self.start = ({k: v.to(dtype) for k, v in truth.items()} if start == "truth" else
                      draw_tree(self.shapes, generator(self.device, seed, 1), dtype))


class System:
    """The port's likelihood of the inputs' configuration, built through
    its public API on the inputs' device."""

    def __init__(self, inputs: Inputs):
        import nifty_tpu_torch as nt

        self.nt, self.inputs = nt, inputs
        config, self.device = inputs.config, inputs.device
        m = config["model"]
        n = int(m["grid_side"])
        cfm = nt.CorrelatedFieldMaker(m["prefix"])
        cfm.set_amplitude_total_offset(offset_mean=m["offset_mean"], offset_std=tuple(m["offset_std"]))
        cfm.add_fluctuations((n, n), distances=1.0 / n, fluctuations=tuple(m["fluctuations"]),
                             loglogavgslope=tuple(m["loglogavgslope"]),
                             flexibility=tuple(m["flexibility"]), n_mode_knots=m.get("n_mode_knots"))
        self.field = cfm.finalize(device=self.device, dtype=getattr(torch, config["dtype"]))
        self.shapes = {k: tuple(v.shape) for k, v in self.field.domain.items()}
        if self.shapes != inputs.shapes:
            raise RuntimeError(f"the program's domain {self.shapes} is not the reference's {inputs.shapes}")
        self.data, self.start = inputs.data, inputs.start
        self.likelihood = nt.Poissonian(self.data, device=self.device).amend(
            nt.ChainModel(torch.exp, self.field))
