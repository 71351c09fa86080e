"""Integrated Wiener process (counterpart of the part of
``nifty_tpu/models/gauss_markov.py`` that the correlated field uses)."""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..model import Model
from ..utils.tree import ShapeWithDtype

__all__ = ["GaussMarkovProcess", "IntegratedWienerProcess", "integrated_wiener_process"]


def integrated_wiener_process(xi, x0, sigma, dt, asperity=None):
    """(Generalised) integrated Wiener process via two chained cumsums.

    ``xi`` has shape (N, 2): one column drives the integrated component,
    the other the underlying Wiener process; ``asperity`` adds a rough
    Wiener component to the integrated coordinate.  Returns (N+1, 2)."""
    asperity = 0.0 if asperity is None else asperity
    amp = sigma * torch.sqrt(dt)
    incr_y = amp * xi[:, 0] * torch.sqrt(dt**2 / 12.0 + asperity)
    incr_s = amp * xi[:, 1]
    incr_y = incr_y + 0.5 * dt * incr_s
    s = _cumsum(torch.cat((x0[1:2], incr_s)))
    y_incr = torch.cat((x0[0:1], incr_y + dt * s[:-1]))
    y = _cumsum(y_incr)
    return torch.stack((y, s), dim=-1)


def _cumsum(x):
    """``torch.cumsum(x, 0)`` accumulated in float64 (complex128), returned
    in ``x``'s dtype."""
    acc = torch.complex128 if x.is_complex() else torch.float64
    return torch.cumsum(x, 0, dtype=acc).to(x.dtype)


class GaussMarkovProcess(Model):
    """A Gauss-Markov generator driven by the excitations ``x[name]``;
    hyper-parameters are models of the same input or constants.  ``x0``
    and ``dt`` are buffers."""

    def __init__(self, process: Callable, x0, dt, name="xi", **kwargs):
        dt = np.asarray(dt, dtype=np.float64)
        x0 = np.asarray(x0, dtype=np.float64)
        domain = {name: ShapeWithDtype(dt.shape + x0.shape)}
        models = {k: v for k, v in kwargs.items() if isinstance(v, Model)}
        for m in models.values():
            domain = {**domain, **m.domain}
        super().__init__(domain=domain)
        self.process = process
        self.name = name
        self.register_buffer("x0", torch.from_numpy(x0))
        self.register_buffer("dt", torch.from_numpy(dt))
        self.hyper_models = torch.nn.ModuleDict(models)
        self.hyper_consts = {k: v for k, v in kwargs.items() if k not in models}

    def forward(self, x):
        hyper = {k: m(x) for k, m in self.hyper_models.items()}
        return self.process(
            xi=x[self.name], x0=self.x0, dt=self.dt, **hyper, **self.hyper_consts
        )


def IntegratedWienerProcess(x0, sigma, dt, name="iwp", asperity=None):
    """Integrated-Wiener-process model, the spectrum-deviation model of the
    correlated field: one step per entry of ``dt``.  ``sigma`` and
    ``asperity`` are models or constants."""
    return GaussMarkovProcess(
        integrated_wiener_process, x0, dt, name=name, sigma=sigma, asperity=asperity
    )
