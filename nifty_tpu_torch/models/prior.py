"""Prior models: named standard-normal reparametrisations (counterpart of
``nifty_tpu/models/prior.py``).

Each is a :class:`~..model.WrappedCall` of a map of
:mod:`..num.stats_distributions` with a white standard-normal initializer;
``name`` keys it in a dict position (or, None, it takes the tensor
itself), ``shape`` and ``dtype`` give its domain.  The tabulated maps are
modules, so their tables follow the prior to its device.
"""

from __future__ import annotations

from ..model import WrappedCall
from ..num.stats_distributions import (
    beta_prior,
    gamma_prior,
    invgamma_prior,
    laplace_prior,
    loginvgamma_prior,
    lognormal_prior,
    normal_prior,
    uniform_prior,
)

__all__ = [
    "BetaPrior",
    "GammaPrior",
    "InvGammaPrior",
    "LaplacePrior",
    "LogInvGammaPrior",
    "LogNormalPrior",
    "NormalPrior",
    "UniformPrior",
]


class NormalPrior(WrappedCall):
    """Standard-normal parameters mapped to N(mean, std²)."""

    def __init__(self, mean, std, **kwargs):
        super().__init__(normal_prior(mean, std), **kwargs)
        self.mean, self.std = mean, std


class LogNormalPrior(WrappedCall):
    """Standard-normal parameters mapped to a log-normal with the given
    linear-space moments."""

    def __init__(self, mean, std, **kwargs):
        super().__init__(lognormal_prior(mean, std), **kwargs)
        self.mean, self.std = mean, std


class LaplacePrior(WrappedCall):
    """Standard-normal parameters mapped to Laplace(scale=alpha)."""

    def __init__(self, alpha, **kwargs):
        super().__init__(laplace_prior(alpha), **kwargs)
        self.alpha = alpha


class UniformPrior(WrappedCall):
    """Standard-normal parameters mapped to Uniform(a_min, a_max)."""

    def __init__(self, a_min, a_max, **kwargs):
        super().__init__(uniform_prior(a_min, a_max), **kwargs)
        self.low, self.high = a_min, a_max


class InvGammaPrior(WrappedCall):
    """Standard-normal parameters mapped to an inverse gamma (tabulated)."""

    def __init__(self, a, scale, loc=0.0, step=1e-2, **kwargs):
        super().__init__(invgamma_prior(a, scale, loc=loc, step=step), **kwargs)
        self.a, self.scale = a, scale


class GammaPrior(WrappedCall):
    """Standard-normal parameters mapped to a gamma (tabulated)."""

    def __init__(self, a, scale=1.0, loc=0.0, step=1e-2, **kwargs):
        super().__init__(gamma_prior(a, scale, loc=loc, step=step), **kwargs)
        self.a, self.scale = a, scale


class BetaPrior(WrappedCall):
    """Standard-normal parameters mapped to beta(a, b) (tabulated)."""

    def __init__(self, a, b, step=1e-2, **kwargs):
        super().__init__(beta_prior(a, b, step=step), **kwargs)
        self.a, self.b = a, b


class LogInvGammaPrior(WrappedCall):
    """Standard-normal parameters mapped to the log of an inverse gamma."""

    def __init__(self, a, scale, loc=0.0, step=1e-2, **kwargs):
        super().__init__(loginvgamma_prior(a, scale, loc=loc, step=step), **kwargs)
        self.a, self.scale = a, scale
