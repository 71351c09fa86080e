"""Multi-grid correlated field: a GP on charted grids by ICR (counterpart
of ``nifty_tpu/multi_grid/correlated_field.py``).

The excitations live per refinement level; the ICR kernel colours them
coarse to fine with matrices from a fixed or learned isotropic
covariance.  O(N) in the fine pixels.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, Union

import torch

from .. import device as _device
from ..model import LazyModel, Model
from ..models.prior import NormalPrior
from ..utils.tree import ShapeWithDtype, random_like
from .grid import Grid
from .kernel import ICRKernel

__all__ = ["ICRField"]


def _excitation_domain(name: str, shapes):
    """The per-level excitations' domain and white initializer."""
    swd = [ShapeWithDtype(s) for s in shapes]
    return {name: swd}, {name: partial(random_like, primals=swd)}


def _add_model(domain, init, model):
    domain.update(model.domain)
    init.update(model.init._call_or_struct)


def _parse_offset(offset, name, domain, init):
    """A float, a ``(mean, std)`` pair (a normal prior named ``name``) or a
    model, whose domain and initializer join ``domain`` and ``init``."""
    if isinstance(offset, (tuple, list)):
        offset = NormalPrior(*offset, name=name)
    if isinstance(offset, LazyModel):
        _add_model(domain, init, offset)
    elif not isinstance(offset, (int, float)):
        raise TypeError(f"invalid offset {offset!r}")
    return offset


class _ICRModel(LazyModel):
    """A field refined by an ICR kernel from per-level excitations, plus an
    offset: ``make_kernel(cov)`` builds the kernel, ``cov`` the fixed
    covariance callable, or None when ``kernel`` is a model that returns
    one (its matrices are then rebuilt per call).  Built on ``device`` (the
    CUDA card by default) in ``dtype``."""

    def __init__(self, grid, kernel, make_kernel, *, offset, prefix, device, dtype):
        name_exc = str(prefix) + "excitations"
        domain, init = _excitation_domain(name_exc, grid.shapes)
        if isinstance(kernel, LazyModel):
            covariance, icr = kernel, make_kernel(None)
            _add_model(domain, init, kernel)
        elif callable(kernel):
            covariance, icr = None, make_kernel(kernel)
        else:
            raise TypeError(f"invalid kernel {kernel!r}")
        offset = _parse_offset(offset, str(prefix) + "offset", domain, init)
        super().__init__(domain=domain, init=init)
        self.grid, self._name_exc = grid, name_exc
        self.kernel, self.covariance, self.offset = icr, covariance, offset
        self.fixed_kernel = covariance is None
        self.to(device=_device.resolve(device), dtype=dtype)

    def forward(self, x):
        mats = None if self.fixed_kernel else self.kernel.matrices(self.covariance(x))
        off = self.offset(x) if isinstance(self.offset, LazyModel) else self.offset
        return off + self.kernel.apply(x[self._name_exc], matrices=mats)


class ICRField(_ICRModel):
    """A correlated field on a charted (multi-)grid (``SimpleOpenGrid``,
    ``LogGrid``, ``MGrid``, ...).  ``kernel`` is a plain callable ``cov(r)``
    (a fixed covariance, its matrices computed once) or a model that
    returns one (a learned covariance, e.g.
    :class:`~.matern.MaternCovarianceModel`; the matrices are rebuilt per
    call, cheap thanks to the stencil deduplication).  ``offset``: a float,
    a ``(mean, std)`` normal prior or a model.  Built on ``device`` (the
    CUDA card by default) in ``dtype``."""

    def __init__(self, grid: Grid, kernel: Union[Model, Callable], *, offset=0.0,
                 rtol: float = 1e-5, atol: float = 1e-10, prefix: str = "icr", device=None,
                 dtype=torch.float32):
        super().__init__(grid, kernel, lambda cov: ICRKernel(grid, cov, rtol=rtol, atol=atol),
                         offset=offset, prefix=prefix, device=device, dtype=dtype)
