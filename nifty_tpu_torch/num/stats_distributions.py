"""Standard-normal -> prior transforms (counterpart of
``nifty_tpu/num/stats_distributions.py``).

Every model parameter is a standard-normal excitation; these maps give it
the wanted prior marginal.  The closed-form maps return a
:func:`functools.partial`; the tabulated ones (inverse-gamma, gamma, beta)
return :class:`Interpolator` modules, whose scipy tables are float64
buffers that follow a model to its device (and stay float64 under
``.to(dtype)``).
"""

from __future__ import annotations

from functools import partial
from typing import Callable, Optional

import numpy as np
import torch

from ..device import Float64Tables

__all__ = [
    "Interpolator",
    "beta_prior",
    "gamma_prior",
    "interpolator",
    "invgamma_invprior",
    "invgamma_prior",
    "laplace_prior",
    "loginvgamma_prior",
    "lognormal_invprior",
    "lognormal_moments",
    "lognormal_prior",
    "normal_invprior",
    "normal_prior",
    "uniform_prior",
]


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


def _normal_to_std(y, *, mean, std):
    return (y - _as(mean, y)) / _as(std, y)


def normal_invprior(mean, std) -> partial:
    """The inverse of :func:`normal_prior`."""
    return partial(_normal_to_std, mean=_scalar(mean), std=_scalar(std))


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


def _lognormal_to_std(y, *, log_mean, log_std):
    return (torch.log(y) - _as(log_mean, y)) / _as(log_std, y)


def lognormal_invprior(mean, std) -> partial:
    """The inverse of :func:`lognormal_prior`."""
    log_mean, log_std = lognormal_moments(mean, std)
    return partial(_lognormal_to_std, log_mean=_scalar(log_mean), log_std=_scalar(log_std))


_LOG2 = float(np.log(2.0))


def _std_to_laplace(xi, *, alpha):
    # symmetric map through the normal log-CDF, stable in the tails
    res = torch.where(xi < 0, torch.special.log_ndtr(xi) + _LOG2, 0.0)
    res = res - torch.where(xi > 0, torch.special.log_ndtr(-xi) + _LOG2, 0.0)
    return res * _as(alpha, xi)


def laplace_prior(alpha) -> partial:
    """Standard normal -> Laplace(scale=alpha)."""
    return partial(_std_to_laplace, alpha=_scalar(alpha))


def _std_to_uniform(xi, *, a_min, scale):
    return _as(a_min, xi) + _as(scale, xi) * torch.special.ndtr(xi)


def uniform_prior(a_min=0.0, a_max=1.0) -> partial:
    """Standard normal -> Uniform(a_min, a_max) through the normal CDF."""
    return partial(_std_to_uniform, a_min=_scalar(a_min),
                   scale=_scalar(np.asarray(a_max) - np.asarray(a_min)))


def interp(x, xp, fp):
    """``jnp.interp(x, xp, fp)``: the piecewise-linear interpolant of the
    increasing knots ``xp`` with values ``fp``, clamped to ``fp[0]`` and
    ``fp[-1]`` outside ``[xp[0], xp[-1]]``.  Its gradient in ``x`` is the
    slope of the segment to the right of a knot (of the last segment at
    ``xp[-1]``) and 0 outside, as ``jnp.interp``'s; plain indexing, so
    ``torch.func.vmap`` batches it."""
    i = torch.searchsorted(xp, x.contiguous(), right=True).clamp(1, xp.numel() - 1)
    x0, x1, f0, f1 = xp[i - 1], xp[i], fp[i - 1], fp[i]
    dx = x1 - x0
    flat = dx.abs() <= float(np.spacing(torch.finfo(xp.dtype).eps))
    f = torch.where(flat, f0, f0 + (x - x0) / torch.where(flat, 1.0, dx) * (f1 - f0))
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


class Interpolator(Float64Tables):
    """The linear interpolant of a table ``ys`` over knots ``xs`` (float64
    buffers), evaluated in float64 and returned in the input's dtype;
    ``post`` (an inverse table transform) is applied to the interpolated
    value, ``pre`` (a table transform) to the input first, and ``scale``
    (a number or a tensor) multiplies the result.  ``.to(device)`` moves
    the tables; a dtype given to ``.to`` leaves them float64."""

    def __init__(self, xs, ys, *, pre: Optional[Callable] = None, post: Optional[Callable] = None,
                 scale=None):
        super().__init__()
        self.register_f64("xs", xs)
        self.register_f64("ys", ys)
        self.pre, self.post, self.scale = pre, post, scale

    def forward(self, x):
        y = x.to(torch.float64)
        if self.pre is not None:
            y = self.pre(y)
        r = interp(y, self.xs.to(y.device), self.ys.to(y.device))
        if self.post is not None:
            r = self.post(r)
        if self.scale is not None:
            r = r * _as(self.scale, r)
        return r.to(x.dtype)


def interpolator(
    func: Callable,
    xmin: float,
    xmax: float,
    *,
    step: Optional[float] = None,
    num: Optional[int] = None,
    table_func: Optional[Callable] = None,
    inv_table_func: Optional[Callable] = None,
    return_inverse: bool = False,
):
    """Tabulate the numpy function ``func`` on ``[xmin, xmax]`` (by ``step``
    or in ``num`` points) and return its linear interpolant, an
    :class:`Interpolator`.  A ``table_func``/``inv_table_func`` pair
    (functions of float64 tensors, ``torch.log``/``torch.exp`` say)
    interpolates in a space where the function is closer to linear.  With
    ``return_inverse`` also the interpolant of the inverse."""
    if (step is None) == (num is None):
        raise ValueError("exactly one of `step`/`num` must be given")
    xs = np.arange(xmin, xmax + step, step) if step is not None else np.linspace(xmin, xmax, num)
    ys = np.asarray(func(xs), np.float64)
    if table_func is not None:
        if inv_table_func is None:
            raise ValueError("no `inv_table_func` specified")
        ys = table_func(torch.from_numpy(ys)).numpy()
    fwd = Interpolator(xs, ys, post=inv_table_func)
    if return_inverse:
        return fwd, Interpolator(ys, xs, pre=table_func)
    return fwd


_XMIN, _XMAX = -8.2, 8.2  # the normal's tail mass beyond is below 1e-15


def invgamma_prior(a, scale, loc=0.0, step=1e-2) -> Interpolator:
    """Standard normal -> inverse-gamma, through a tabulated quantile map."""
    from scipy.stats import invgamma, norm

    if not np.isscalar(a) or not np.isscalar(loc):
        raise TypeError("shape `a` and location `loc` must be scalars")
    if loc == 0.0:
        s2i = lambda x: invgamma.ppf(norm._cdf(x), a=a)  # noqa: E731
    elif np.isscalar(scale):
        s2i = lambda x: invgamma.ppf(norm._cdf(x), a=a, loc=loc, scale=scale)  # noqa: E731
    else:
        raise TypeError("array-like `scale` requires `loc == 0`")
    ip = interpolator(s2i, _XMIN, _XMAX, step=step, table_func=torch.log, inv_table_func=torch.exp)
    if loc == 0.0:
        ip.scale = _scalar(scale)
    return ip


def invgamma_invprior(a, scale, loc=0.0, step=1e-2) -> Interpolator:
    """Inverse-gamma -> standard normal, the inverse tabulated map."""
    from scipy.stats import invgamma, norm

    _, inv = interpolator(
        lambda x: invgamma.ppf(norm._cdf(x), a=a, loc=loc, scale=scale),
        _XMIN, _XMAX, step=step, table_func=torch.log, inv_table_func=torch.exp,
        return_inverse=True,
    )
    return inv


def gamma_prior(a, scale=1.0, loc=0.0, step=1e-2) -> Interpolator:
    """Standard normal -> gamma, through a tabulated quantile map."""
    from scipy.stats import gamma, norm

    if not np.isscalar(a) or not np.isscalar(loc):
        raise TypeError("shape `a` and location `loc` must be scalars")
    if loc == 0.0:
        ip = interpolator(lambda x: gamma.ppf(norm._cdf(x), a=a), _XMIN, _XMAX, step=step,
                          table_func=torch.log, inv_table_func=torch.exp)
        ip.scale = _scalar(scale)
        return ip
    return interpolator(lambda x: gamma.ppf(norm._cdf(x), a=a, loc=loc, scale=scale),
                        _XMIN, _XMAX, step=step)


def _logit(p):
    return torch.log(p) - torch.log1p(-p)


def _expit(y):
    return 1.0 / (1.0 + torch.exp(-y))


def beta_prior(a, b, step=1e-2) -> Interpolator:
    """Standard normal -> beta(a, b) on (0, 1), through tabulated quantiles
    interpolated in logit space (the bounds stay exact)."""
    from scipy.stats import beta as beta_dist, norm

    return interpolator(lambda x: beta_dist.ppf(norm._cdf(x), a=a, b=b), _XMIN, _XMAX,
                        step=step, table_func=_logit, inv_table_func=_expit)


def loginvgamma_prior(a, scale, loc=0.0, step=1e-2) -> torch.nn.Module:
    """Standard normal -> the log of an inverse-gamma variate."""
    return _Log(invgamma_prior(a, scale, loc=loc, step=step))


class _Log(torch.nn.Module):
    def __init__(self, inner):
        super().__init__()
        self.inner = inner

    def forward(self, x):
        return torch.log(self.inner(x))
