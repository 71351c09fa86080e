"""Gauss-Markov processes: Wiener, integrated Wiener, Ornstein-Uhlenbeck
and the general discrete process (counterpart of
``nifty_tpu/models/gauss_markov.py``).

The Wiener processes are cumulative sums and the general process a
log-depth scan of affine maps (Hillis-Steele doubling: ``log2 N`` batched
matrix products, no host loop over the steps).  Every scan accumulates in
float64 (complex128) and returns the input's dtype: a float32 scan of
10⁵ steps, batched over samples on the card, drifted by 1e-3 of the
gradient it fed.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..model import LazyModel, Model, _white
from ..utils.tree import ShapeWithDtype
from .prior import LogNormalPrior, NormalPrior

__all__ = [
    "GaussMarkovProcess",
    "IntegratedWienerProcess",
    "OrnsteinUhlenbeckProcess",
    "WienerProcess",
    "discrete_gauss_markov_process",
    "integrated_wiener_process",
    "ornstein_uhlenbeck_process",
    "scalar_gauss_markov_process",
    "wiener_process",
]


def _acc_dtype(x):
    return torch.complex128 if x.is_complex() else torch.float64


def _cumsum(x):
    """``torch.cumsum(x, 0)`` accumulated in float64 (complex128), returned
    in ``x``'s dtype."""
    return torch.cumsum(x, 0, dtype=_acc_dtype(x)).to(x.dtype)


def _isscalar(x):
    return not torch.is_tensor(x) or x.ndim == 0


def _as_tensor(v, like):
    if torch.is_tensor(v):
        return v.to(like.device)
    return torch.as_tensor(v, dtype=like.dtype, device=like.device)


def discrete_gauss_markov_process(xi, x0, drift, diffamp):
    """The general discrete process ``x_{i+1} = drift_i @ x_i + diffamp_i @
    xi_i`` from ``x0``: ``xi`` ``(N, d)``, ``drift`` and ``diffamp`` ``(d, d)``
    or ``(N, d, d)`` (a scalar is a 1×1 matrix).  Returns ``(N+1, d)``.  The
    composition of the affine steps is associative, so it runs as a
    doubling scan in float64."""
    out_dtype = xi.dtype
    acc = _acc_dtype(xi)
    xi = xi.to(acc)
    n = xi.shape[0]
    drift = _as_tensor(drift, xi).to(acc)
    diffamp = _as_tensor(diffamp, xi).to(acc)
    if drift.ndim == 0:
        drift = drift * torch.ones((1, 1), dtype=acc, device=xi.device)
    if diffamp.ndim == 0:
        diffamp = diffamp * torch.ones((1, 1), dtype=acc, device=xi.device)
    b = torch.einsum("...ij,...j->...i", diffamp, xi)
    a = drift if drift.ndim == 3 else drift.expand((n,) + tuple(drift.shape))
    # inclusive scan of (A, b) under (A2, b2) ∘ (A1, b1) = (A2 A1, A2 b1 + b2)
    shift = 1
    while shift < n:
        a_hi, b_hi = a[shift:], b[shift:]
        b = torch.cat((b[:shift], torch.einsum("nij,nj->ni", a_hi, b[:-shift]) + b_hi))
        a = torch.cat((a[:shift], a_hi @ a[:-shift]))
        shift *= 2
    x0 = _as_tensor(x0, xi).to(acc)
    states = torch.einsum("nij,j->ni", a, x0) + b
    return torch.cat((x0.unsqueeze(0), states)).to(out_dtype)


def scalar_gauss_markov_process(xi, x0, drift, diffamp):
    """:func:`discrete_gauss_markov_process` of a scalar process: ``xi``
    ``(N,)``, scalar or ``(N,)`` drift and amplitude.  Returns ``(N+1,)``."""
    if not _isscalar(drift):
        drift = drift[:, None, None]
    if not _isscalar(diffamp):
        diffamp = diffamp[:, None, None]
    x0 = _as_tensor(x0, xi)
    if x0.ndim == 0:
        x0 = x0.reshape(1)
    return discrete_gauss_markov_process(xi[:, None], x0, drift, diffamp)[:, 0]


def wiener_process(xi, x0, sigma, dt):
    """Wiener process: ``x_{i+1} = x_i + sigma √dt ξ_i`` (a cumulative sum)."""
    amp = torch.sqrt(dt) * sigma
    x0 = _as_tensor(x0, xi).reshape(-1)
    return _cumsum(torch.cat((x0, amp * xi)))


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


def ornstein_uhlenbeck_process(xi, x0, sigma, gamma, dt):
    """Ornstein-Uhlenbeck process through the general scan."""
    drift = torch.exp(-gamma * dt)
    amp = sigma * torch.sqrt(1.0 - drift**2)
    return scalar_gauss_markov_process(xi, x0, drift, amp)


class GaussMarkovProcess(Model):
    """A Gauss-Markov generator driven by the excitations ``x[name]``; ``x0``
    and the hyper-parameters are models of the same input or constants.
    ``dt`` (an array, or a scalar with ``N_steps``) and a constant ``x0``
    are float64 buffers."""

    def __init__(self, process: Callable, x0, dt, name="xi", N_steps=None, **kwargs):
        if np.ndim(dt) == 0:
            if N_steps is None:
                raise ValueError("`N_steps` required when `dt` is scalar")
            dt = np.ones(N_steps) * dt
        dt = np.asarray(dt, dtype=np.float64)
        x0_model = x0 if isinstance(x0, LazyModel) else None
        x0_shape = x0.target.shape if x0_model is not None else np.shape(x0)
        domain = {name: ShapeWithDtype(dt.shape + tuple(x0_shape))}
        init = _white(domain)
        models = {k: v for k, v in kwargs.items() if isinstance(v, LazyModel)}
        for m in ([x0_model] if x0_model is not None else []) + list(models.values()):
            domain = {**domain, **m.domain}
            init = {**init, **m.init._call_or_struct}
        super().__init__(domain=domain, init=init)
        self.process = process
        self.name = name
        self.x0_model = x0_model
        if x0_model is None:
            self.register_buffer("x0", torch.from_numpy(np.asarray(x0, dtype=np.float64)))
        self.register_buffer("dt", torch.from_numpy(dt))
        self.hyper_models = torch.nn.ModuleDict(models)
        self.hyper_consts = {k: v for k, v in kwargs.items() if k not in models}

    def forward(self, x):
        hyper = {k: m(x) for k, m in self.hyper_models.items()}
        x0 = self.x0_model(x) if self.x0_model is not None else self.x0
        return self.process(xi=x[self.name], x0=x0, dt=self.dt, **hyper, **self.hyper_consts)


def WienerProcess(x0, sigma, dt, name="wp", N_steps=None):
    """Wiener-process model; tuple hyper-parameters become priors."""
    if isinstance(x0, tuple):
        x0 = NormalPrior(x0[0], x0[1], name=name + "_x0")
    if isinstance(sigma, tuple):
        sigma = LogNormalPrior(sigma[0], sigma[1], name=name + "_sigma")
    return GaussMarkovProcess(wiener_process, x0, dt, name=name, N_steps=N_steps, sigma=sigma)


def IntegratedWienerProcess(x0, sigma, dt, name="iwp", asperity=None, N_steps=None):
    """Integrated-Wiener-process model, the spectrum-deviation model of the
    correlated field: one step per entry of ``dt``.  ``sigma`` and
    ``asperity`` are models or constants, or ``(mean, std)`` tuples of
    log-normal priors; ``x0`` a constant or a ``(means, stds)`` pair of
    normal priors of shape (2,)."""
    if isinstance(x0, tuple):
        if np.shape(x0[0]) != (2,):
            raise ValueError("x0 tuple must be (array(mean, mean), array(std, std))")
        x0 = NormalPrior(x0[0], x0[1], shape=(2,), name=name + "_x0")
    if isinstance(sigma, tuple):
        sigma = LogNormalPrior(sigma[0], sigma[1], name=name + "_sigma")
    if isinstance(asperity, tuple):
        asperity = LogNormalPrior(asperity[0], asperity[1], name=name + "_asperity")
    return GaussMarkovProcess(integrated_wiener_process, x0, dt, name=name, N_steps=N_steps,
                              sigma=sigma, asperity=asperity)


class _SteadyStateX0(Model):
    """The OU process's start drawn from its steady state: ``x[key]`` times
    the first ``sigma``."""

    def __init__(self, key, sigma):
        domain = {key: ShapeWithDtype(())}
        init = _white(domain)
        if isinstance(sigma, LazyModel):
            domain = {**domain, **sigma.domain}
            init = {**init, **sigma.init._call_or_struct}
        super().__init__(domain=domain, init=init)
        self.key = key
        self.sigma = sigma

    def forward(self, x):
        sig = self.sigma(x) if isinstance(self.sigma, LazyModel) else self.sigma
        sig0 = sig if _isscalar(sig) else sig[0]
        return x[self.key] * sig0


def OrnsteinUhlenbeckProcess(sigma, gamma, dt, name="oup", x0=None, N_steps=None):
    """Ornstein-Uhlenbeck-process model; with no ``x0`` its start is drawn
    from the steady state."""
    if isinstance(sigma, tuple):
        sigma = LogNormalPrior(sigma[0], sigma[1], name=name + "_sigma")
    if isinstance(gamma, tuple):
        gamma = LogNormalPrior(gamma[0], gamma[1], name=name + "_gamma")
    if x0 is None:
        x0 = _SteadyStateX0(name + "_x0", sigma)
    elif isinstance(x0, tuple):
        x0 = NormalPrior(x0[0], x0[1], name=name + "_x0")
    return GaussMarkovProcess(ornstein_uhlenbeck_process, x0, dt, name=name, N_steps=N_steps,
                              sigma=sigma, gamma=gamma)
