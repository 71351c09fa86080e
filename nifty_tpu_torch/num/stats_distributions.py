"""Standard-normal -> prior transforms (counterpart of
``nifty_tpu/num/stats_distributions.py``).

Every model parameter is a standard-normal excitation; these maps give it
the wanted prior marginal.  Each returns a :func:`functools.partial`.
"""

from __future__ import annotations

from functools import partial

import numpy as np
import torch

__all__ = ["lognormal_moments", "lognormal_prior", "normal_prior"]


def _scalar(v):
    """Python float for 0-d parameters, so they never promote tensor dtypes."""
    a = np.asarray(v)
    return float(a) if a.ndim == 0 else torch.from_numpy(a)


def _as(v, x):
    return v.to(device=x.device, dtype=x.dtype) if torch.is_tensor(v) else v


def _std_to_normal(xi, *, mean, std):
    return _as(mean, xi) + _as(std, xi) * xi


def normal_prior(mean, std) -> partial:
    """Affine map: standard normal -> N(mean, std²)."""
    return partial(_std_to_normal, mean=_scalar(mean), std=_scalar(std))


def lognormal_moments(mean, std):
    """Log-space cumulants matching the given linear-space mean and std."""
    mean, std = np.asarray(mean), np.asarray(std)
    if np.any(mean <= 0.0):
        raise ValueError(f"`mean` must be greater than zero; got {mean!r}")
    if np.any(std <= 0.0):
        raise ValueError(f"`std` must be greater than zero; got {std!r}")
    logstd = np.sqrt(np.log1p((std / mean) ** 2))
    logmean = np.log(mean) - 0.5 * logstd**2
    return logmean, logstd


def _std_to_lognormal(xi, *, log_mean, log_std):
    return torch.exp(_as(log_mean, xi) + _as(log_std, xi) * xi)


def lognormal_prior(mean, std) -> partial:
    """Moment-matched map: standard normal -> log-normal(mean, std)."""
    log_mean, log_std = lognormal_moments(mean, std)
    return partial(_std_to_lognormal, log_mean=_scalar(log_mean), log_std=_scalar(log_std))
