"""Matérn-family isotropic covariance functions from power spectra
(counterpart of ``nifty_tpu/multi_grid/matern.py``).

The multi-grid GP needs the covariance as a function of distance; the
Matérn family is parametrised in the spectral domain,

    P(k) ∝ (1 + (k/cutoff)²)^(loglogslope/2) ,

so the radial covariance is the d-dimensional isotropic inverse Fourier
transform

    C(r) ∝ ∫ dk k^{d-1} P(k) Λ_d(kr),   Λ_1 = cos, Λ_2 = J₀, Λ_3 = sinc,

evaluated by log-k quadrature on a static grid and tabulated on a log-r
grid for a cheap differentiable interpolation.  ``J₀`` is the JAX
package's rational/asymptotic split (Abramowitz & Stegun 9.4.1/9.4.3,
~1e-8 in double precision): ``torch.special.bessel_j0`` is exact and so
differs from it by more than 1e-12.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch
from torch.utils._pytree import tree_leaves

from ..device import Const
from ..model import LazyModel, Model
from ..models.prior import LogNormalPrior, NormalPrior
from ..num.stats_distributions import interp

__all__ = [
    "IsotropicPowerSpectrumTransform",
    "MaternCovarianceModel",
    "bessel_j0",
    "matern_spectral_covariance",
]


def bessel_j0(x):
    """J₀(x), Abramowitz & Stegun 9.4.1/9.4.3 rational approximations."""
    x = torch.as_tensor(x)
    ax = torch.abs(x)
    y = x * x
    p1 = 57568490574.0 + y * (-13362590354.0 + y * (651619640.7 + y * (
        -11214424.18 + y * (77392.33017 + y * (-184.9052456)))))
    q1 = 57568490411.0 + y * (1029532985.0 + y * (9494680.718 + y * (
        59272.64853 + y * (267.8532712 + y))))
    small = p1 / q1
    z = 8.0 / torch.clamp_min(ax, 1e-30)
    y2 = z * z
    xx = ax - 0.785398164
    p2 = 1.0 + y2 * (-0.1098628627e-2 + y2 * (0.2734510407e-4 + y2 * (
        -0.2073370639e-5 + y2 * 0.2093887211e-6)))
    q2 = -0.1562499995e-1 + y2 * (0.1430488765e-3 + y2 * (-0.6911147651e-5 + y2 * (
        0.7621095161e-6 + y2 * (-0.934935152e-7))))
    large = torch.sqrt(0.636619772 / torch.clamp_min(ax, 1e-30)) * (
        torch.cos(xx) * p2 - z * torch.sin(xx) * q2)
    return torch.where(ax < 8.0, small, large)


def _radial_weight(d: int, kr):
    if d == 1:
        return torch.cos(kr)
    if d == 2:
        return bessel_j0(kr)
    if d == 3:
        return torch.sinc(kr / np.pi)  # sin(kr)/(kr)
    raise ValueError(f"unsupported dimension {d}")


def matern_spectral_covariance(*, ndim: int, r_min: float, r_max: float, n_integrate: int = 2000,
                               n_interpolate: int = 512, kr_cut: float = 1e4) -> Callable:
    """``cov_factory(scale, cutoff, loglogslope) -> cov(r)``: the quadrature
    nodes over the dimensionless ``q = k/cutoff`` and the radii of the
    table are static, so the learned path is one weighted contraction and
    an interpolation, both differentiable."""
    ndim = int(ndim)
    rs = np.geomspace(max(r_min, 1e-12), r_max * 1.5, n_interpolate)
    q_np = np.geomspace(1e-4, kr_cut, n_integrate)
    q_c, rs_c, log_rs_c = Const(q_np), Const(rs), Const(np.log(rs))
    dlq = float(np.log(q_np[1] / q_np[0]))

    def cov_factory(scale, cutoff, loglogslope):
        scale, cutoff, loglogslope = (torch.as_tensor(v) for v in (scale, cutoff, loglogslope))
        dt = scale.dtype
        q = q_c.like(scale, dt)
        spec = (1.0 + q**2) ** (loglogslope / 2.0)
        wt = q**ndim * spec * dlq  # k^{d-1} dk = q^d dlog q · cutoff^d (cancels)
        kr = q[None, :] * (cutoff * rs_c.like(scale, dt))[:, None]
        integ = _radial_weight(ndim, kr) @ wt
        cov_tab = scale**2 * integ / torch.sum(wt)  # Λ_d(0) = 1
        log_rs = log_rs_c.like(scale, dt)

        def cov(r):
            r = torch.as_tensor(r)
            c = interp(torch.log(torch.clamp_min(r, rs[0])), log_rs.to(r.dtype), cov_tab.to(r.dtype))
            return torch.where(r <= rs[0], scale**2, c)

        return cov

    return cov_factory


class MaternCovarianceModel(LazyModel):
    """A learnable Matérn covariance: log-normal priors on the scale and the
    cutoff, a normal prior on the spectral slope (each a ``(mean, std)``
    pair, a model, or a fixed float).  Called on a position it returns the
    distance-covariance function the ICR kernels take."""

    def __init__(self, *, ndim: int, r_min: float, r_max: float, scale=(1.0, 0.5),
                 cutoff=(1.0, 0.5), loglogslope=(-4.0, 0.5), n_integrate: int = 2000,
                 n_interpolate: int = 512, prefix: str = "matern"):
        def parse(v, name, prior):
            if isinstance(v, Model):
                return v
            if isinstance(v, (tuple, list)):
                return prior(*v, name=prefix + name)
            return float(v)

        params = (parse(scale, "scale", LogNormalPrior), parse(cutoff, "cutoff", LogNormalPrior),
                  parse(loglogslope, "loglogslope", NormalPrior))
        domain, init = {}, None
        for p in params:
            if isinstance(p, Model):
                domain.update(p.domain)
                init = p.init if init is None else init | p.init
        super().__init__(domain=domain, init=init)
        self.scale, self.cutoff, self.loglogslope = params
        self._factory = matern_spectral_covariance(ndim=ndim, r_min=r_min, r_max=r_max,
                                                   n_integrate=n_integrate,
                                                   n_interpolate=n_interpolate)

    def forward(self, x):
        """The covariance function, computed in float64 (its table and its
        values): the ICR kernels derive conditional covariances from it."""
        device = tree_leaves(x)[0].device

        def ev(p):
            v = p(x) if isinstance(p, Model) else torch.tensor(p, device=device)
            return v.to(torch.float64)

        return self._factory(ev(self.scale), ev(self.cutoff), ev(self.loglogslope))


class IsotropicPowerSpectrumTransform:
    """Isotropic power spectrum -> radial covariance,

        Cov(r) = (2π)^{-d} S_{d-1} ∫₀^∞ P(k) k^{d-1} Λ_d(k r) dk,

    on a static log-k grid with one head node covering [0, k_min)
    analytically, for d = 1, 2, 3 (S₀..₂ = 2, 2π, 4π).  Call with a spectrum
    callable (of a tensor of k) and radii: ``transform(P, r) -> Cov``."""

    def __init__(self, ndim: int, n_nodes: int = 4096, k_min: float = 1e-4, k_max: float = 1e4):
        if ndim not in (1, 2, 3):
            raise ValueError("ndim must be 1, 2, or 3")
        self.ndim = int(ndim)
        k = np.geomspace(k_min, k_max, int(n_nodes))
        dlk = float(np.log(k[1] / k[0]))
        surface = {1: 2.0, 2: 2.0 * np.pi, 3: 4.0 * np.pi}[self.ndim]
        pref = surface / (2.0 * np.pi) ** self.ndim
        k = np.concatenate(([0.5 * k_min], k))
        w = np.concatenate(([k_min**self.ndim / self.ndim], k[1:] ** self.ndim * dlk))
        self._k, self._w = Const(k), Const(pref * w)

    def __call__(self, power_spectrum: Callable, r):
        r = torch.as_tensor(r)
        k = self._k.like(r, r.dtype)
        pk = power_spectrum(k)
        lam = _radial_weight(self.ndim, k * r[..., None])
        return torch.sum(lam * (pk * self._w.like(r, r.dtype)), dim=-1)
