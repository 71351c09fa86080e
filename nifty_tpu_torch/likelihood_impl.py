"""Standard likelihoods (counterpart of ``nifty_tpu/likelihood_impl.py``).

Data are one tensor: a tensor stays on its device unless ``device`` is
given; other data (numpy arrays, lists) go to ``device``, the CUDA card by
default.  The variable-covariance likelihoods take pairs ``(mean, std_inv)``
(or ``(mean, std)``) as their position and their LSM tangents.

Energies accumulate their sums in float64 (:func:`_sum`): a float32 sum
over a 1280² grid is some 1e6 nats, whose float32 spacing alone is a
tenth of a nat, while HMC and NUTS turn energy differences straight into
acceptance probabilities.  Only the rounding changes; float64 inputs sum
as before.  In a field-sharded run (inside
:func:`~.parallel.collectives.field_sharded`) the data are the rank's rows
of the field, and every such sum is summed over the field group.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Union

import torch

from . import device as _device
from .likelihood import Likelihood
from .utils.tree import ShapeWithDtype
from .utils.tree_linalg import sym_logm, sym_solve, sym_sqrtm

__all__ = [
    "Bernoulli",
    "Categorical",
    "Gaussian",
    "InverseGamma",
    "NDVariableCovarianceGaussian",
    "Poissonian",
    "StudentT",
    "VariableCovarianceGaussian",
    "VariableCovarianceStudentT",
]


def _as_data(data, device):
    if isinstance(data, torch.Tensor):
        return data if device is None else data.to(device)
    return torch.as_tensor(data, device=_device.resolve(device))


def _sum(x):
    """``Σ x`` accumulated in float64 (over the field group's rows in a
    field-sharded run)."""
    from .parallel.collectives import field, reduce_sum

    total = torch.sum(x, dtype=torch.float64)
    ctx = field()
    return total if ctx is None else reduce_sum(total, ctx.group)


def _real_vdot(a, b):
    """``Re ⟨a, b⟩`` (``a`` conjugated), accumulated in float64."""
    return _sum((a.conj() * b).real)


def _as_weight(w, data):
    """A weight as a tensor on the data's device; a number in the data's
    real dtype."""
    if isinstance(w, torch.Tensor):
        return w.to(data.device)
    return torch.as_tensor(w, device=data.device, dtype=data.real.dtype)


def _standard_t(nwr, dof):
    """The Student-t energy of normalized residuals ``nwr``."""
    return 0.5 * _sum((dof + 1.0) * torch.log1p((nwr.conj() * nwr).real / dof))


class _NoiseWeighted(Likelihood):
    """A likelihood with a fixed noise covariance: ``noise_cov_inv`` and
    ``noise_std_inv`` are callables or diagonal weights; a missing one
    follows from the other for a diagonal covariance; with neither the
    noise is white."""

    def _set_noise(self, data, noise_cov_inv, noise_std_inv):
        cov, std = noise_cov_inv, noise_std_inv
        if cov is not None or std is not None:
            ones = torch.ones_like(data.real)
            if cov is None:
                cov = (std(ones) if callable(std) else _as_weight(std, data) * ones) ** 2
            if std is None:
                std = torch.sqrt(cov(ones) if callable(cov) else _as_weight(cov, data) * ones)
        self._cov_fn = cov if callable(cov) else None
        self._std_fn = std if callable(std) else None
        weight = lambda w: None if w is None or callable(w) else _as_weight(w, data)  # noqa: E731
        self.register_buffer("cov_weight", weight(cov))
        self.register_buffer("std_weight", weight(std))

    @staticmethod
    def _apply(fn, weight, x):
        if fn is not None:
            return fn(x)
        return x if weight is None else weight * x

    def noise_cov_inv(self, x):
        return self._apply(self._cov_fn, self.cov_weight, x)

    def noise_std_inv(self, x):
        return self._apply(self._std_fn, self.std_weight, x)


class Gaussian(_NoiseWeighted):
    """Gaussian likelihood with fixed noise covariance:
    E(f) = ½ Re (d-f)ᴴ N⁻¹ (d-f), transformation(f) = N^{-1/2} f.  Complex
    data take complex LSM tangents."""

    def __init__(
        self,
        data,
        noise_cov_inv: Optional[Union[Callable, torch.Tensor]] = None,
        noise_std_inv: Optional[Union[Callable, torch.Tensor]] = None,
        device=None,
    ):
        super().__init__()
        data = _as_data(data, device)
        self.register_buffer("data", data)
        self._set_noise(data, noise_cov_inv, noise_std_inv)

    def energy(self, primals):
        res = self.data - primals
        return 0.5 * _real_vdot(res, self.noise_cov_inv(res))

    def normalized_residual(self, primals):
        return self.noise_std_inv(self.data - primals)

    def metric(self, primals, tangents):
        return self.noise_cov_inv(tangents)

    def left_sqrt_metric(self, primals, tangents):
        return self.noise_std_inv(tangents)

    def right_sqrt_metric(self, primals, tangents):
        return self.noise_std_inv(tangents)

    def transformation(self, primals):
        return self.noise_std_inv(primals)


class StudentT(_NoiseWeighted):
    """Student's t likelihood with a fixed scale (the noise pair as for
    :class:`Gaussian`) and ``dof`` degrees of freedom (a number or a tensor
    of the data's shape); its Fisher metric is ``(dof+1)/(dof+3) N⁻¹``."""

    def __init__(self, data, dof, noise_cov_inv=None, noise_std_inv=None, device=None):
        super().__init__()
        data = _as_data(data, device)
        self.register_buffer("data", data)
        if isinstance(dof, (int, float)):
            self.dof = float(dof)
        else:
            self.register_buffer("dof", _as_weight(dof, data))
        self._set_noise(data, noise_cov_inv, noise_std_inv)

    def _fct(self):
        return (self.dof + 1.0) / (self.dof + 3.0)

    def energy(self, primals):
        return _standard_t(self.noise_std_inv(self.data - primals), self.dof)

    def metric(self, primals, tangents):
        return self.noise_cov_inv(self._fct() * tangents)

    def left_sqrt_metric(self, primals, tangents):
        fct = self._fct()
        fct = math.sqrt(fct) if isinstance(fct, float) else torch.sqrt(fct)
        return self.noise_std_inv(fct * tangents)

    def right_sqrt_metric(self, primals, tangents):
        return self.left_sqrt_metric(primals, tangents)

    def normalized_residual(self, primals):
        return self.left_sqrt_metric(None, self.data - primals)

    def transformation(self, primals):
        return self.left_sqrt_metric(None, primals)


class Poissonian(Likelihood):
    """Poisson count likelihood: E(λ) = Σλ - dᵀ log λ, with the geometric
    transformation 2√λ."""

    def __init__(self, data, device=None):
        super().__init__()
        data = _as_data(data, device)
        if data.is_floating_point() or data.is_complex():
            raise TypeError("Poisson `data` must have integer dtype")
        self.register_buffer("data", data)

    def energy(self, primals):
        return _sum(primals) - _sum(torch.log(primals) * self.data)

    def metric(self, primals, tangents):
        return tangents / primals

    def left_sqrt_metric(self, primals, tangents):
        return tangents / torch.sqrt(primals)

    def right_sqrt_metric(self, primals, tangents):
        return self.left_sqrt_metric(primals, tangents)

    def normalized_residual(self, primals):
        return self.left_sqrt_metric(primals, self.data - primals)

    def transformation(self, primals):
        return 2.0 * torch.sqrt(primals)


class Bernoulli(Likelihood):
    """Bernoulli likelihood of binary data over event probabilities p:
    E(p) = -Σ [d log p + (1-d) log(1-p)], metric 1/(p(1-p)), the geodesic
    transformation 2 arcsin √p.  LSM tangents are drawn in the position's
    dtype, whatever the data's."""

    def __init__(self, data, device=None):
        super().__init__()
        self.register_buffer("data", _as_data(data, device))

    @property
    def lsm_tangents_shape(self):
        return ShapeWithDtype(tuple(self.data.shape))

    def energy(self, primals):
        d = self.data
        return -_sum(d * torch.log(primals) + (1.0 - d) * torch.log1p(-primals))

    def metric(self, primals, tangents):
        return tangents / (primals * (1.0 - primals))

    def left_sqrt_metric(self, primals, tangents):
        return tangents / torch.sqrt(primals * (1.0 - primals))

    def right_sqrt_metric(self, primals, tangents):
        return self.left_sqrt_metric(primals, tangents)

    def normalized_residual(self, primals):
        return self.left_sqrt_metric(primals, self.data - primals)

    def transformation(self, primals):
        return 2.0 * torch.arcsin(torch.sqrt(primals))


class VariableCovarianceGaussian(Likelihood):
    """Gaussian likelihood of a position ``(mean, std_inv)``: the mean and
    the inverse noise standard deviation, both inferred.  Complex data
    count twice in the log-determinant and the metric of ``std_inv``.  The
    transformation is a local approximation (no global one exists); the
    RSM is the LSM's transpose."""

    def __init__(self, data, device=None):
        super().__init__()
        self.register_buffer("data", _as_data(data, device))
        self.iscomplex = int(self.data.is_complex())

    @property
    def lsm_tangents_shape(self):
        d = self.data
        return (ShapeWithDtype.from_leave(d), ShapeWithDtype(tuple(d.shape), d.real.dtype))

    def energy(self, primals):
        mean, std_inv = primals
        res = (self.data - mean) * std_inv
        return 0.5 * _real_vdot(res, res) - (1 + self.iscomplex) * _sum(torch.log(std_inv))

    def metric(self, primals, tangents):
        _, std_inv = primals
        t_mean, t_std_inv = tangents
        si_sq = std_inv**2
        return (si_sq * t_mean, 2.0 * (1 + self.iscomplex) * t_std_inv / si_sq)

    def left_sqrt_metric(self, primals, tangents):
        _, std_inv = primals
        t_mean, t_std_inv = tangents
        return (std_inv * t_mean, math.sqrt(2.0) ** (1 + self.iscomplex) * t_std_inv / std_inv)

    def transformation(self, primals):
        mean, std_inv = primals
        return (std_inv * (mean - self.data), (1 + self.iscomplex) * torch.log(std_inv))

    def normalized_residual(self, primals):
        mean, std_inv = primals
        return (self.data - mean) * std_inv


class VariableCovarianceStudentT(Likelihood):
    """Student's t likelihood of a position ``(mean, std)`` with ``dof``
    degrees of freedom (a number)."""

    def __init__(self, data, dof, device=None):
        super().__init__()
        self.register_buffer("data", _as_data(data, device))
        self.dof = float(dof)

    @property
    def lsm_tangents_shape(self):
        shp = ShapeWithDtype.from_leave(self.data)
        return (shp, shp)

    def energy(self, primals):
        mean, std = primals
        return _standard_t((self.data - mean) / std, self.dof) + _sum(torch.log(std))

    def metric(self, primals, tangents):
        _, std = primals
        t_mean, t_std = tangents
        d = self.dof
        return (t_mean * (d + 1.0) / (d + 3.0) / std**2, t_std * 2.0 * d / (d + 3.0) / std**2)

    def left_sqrt_metric(self, primals, tangents):
        _, std = primals
        t_mean, t_std = tangents
        d = self.dof
        return (math.sqrt((d + 1.0) / (d + 3.0)) / std * t_mean,
                math.sqrt(2.0 * d / (d + 3.0)) / std * t_std)

    def right_sqrt_metric(self, primals, tangents):
        return self.left_sqrt_metric(primals, tangents)

    def normalized_residual(self, primals):
        mean, std = primals
        d = self.dof
        return (self.data - mean) / std * math.sqrt((d + 1.0) / (d + 3.0))


class Categorical(Likelihood):
    """Categorical (cross-entropy) likelihood of logits: ``data`` holds the
    class indices, with the logits' number of dimensions (size 1 along
    ``axis``), and the softmax runs along ``axis``.  LSM tangents have the
    data's shape and ``sampling_dtype``, the position's dtype when None."""

    def __init__(self, data, axis=-1, sampling_dtype=None, device=None):
        super().__init__()
        self.register_buffer("data", _as_data(data, device))
        self.axis = axis
        self.sampling_dtype = sampling_dtype

    @property
    def lsm_tangents_shape(self):
        return ShapeWithDtype(tuple(self.data.shape), self.sampling_dtype)

    def energy(self, primals):
        logits = torch.log_softmax(primals, dim=self.axis)
        return -_sum(torch.gather(logits, self.axis, self.data.long()))

    def metric(self, primals, tangents):
        pr = torch.softmax(primals, dim=self.axis)
        norm = torch.sum(pr * tangents, dim=self.axis, keepdim=True)
        return pr * tangents - pr * norm

    def left_sqrt_metric(self, primals, tangents):
        sq = torch.sqrt(torch.softmax(primals, dim=self.axis))
        norm = torch.sum(sq * tangents, dim=self.axis, keepdim=True)
        return sq * (tangents - sq * norm)

    def right_sqrt_metric(self, primals, tangents):
        return self.left_sqrt_metric(primals, tangents)


class InverseGamma(Likelihood):
    """Inverse-gamma likelihood of a positive (variance-like) signal x:
    E(x) = Σ (α+1) ln x + β/x.  Its Euclidean transformation √(α+1) ln x
    gives the metric (α+1)/x²; the RSM is the LSM's transpose."""

    def __init__(self, beta, alpha=-0.5, device=None):
        super().__init__()
        beta = _as_data(beta, device)
        self.register_buffer("beta", beta)
        self.register_buffer("alpha", torch.broadcast_to(_as_weight(alpha, beta), beta.shape))

    @property
    def lsm_tangents_shape(self):
        return ShapeWithDtype.from_leave(self.beta)

    def energy(self, primals):
        return _sum((self.alpha + 1.0) * torch.log(primals) + self.beta / primals)

    def transformation(self, primals):
        return torch.sqrt(self.alpha + 1.0) * torch.log(primals)

    def metric(self, primals, tangents):
        return (self.alpha + 1.0) / (primals * primals) * tangents

    def left_sqrt_metric(self, primals, tangents):
        return torch.sqrt(self.alpha + 1.0) / primals * tangents

    def normalized_residual(self, primals):
        a = self.alpha
        return torch.sqrt(a + 1.0) * (torch.log(primals) - torch.log(self.beta / (a + 2.0)))


def _matvec(m, x):
    return (m @ x.unsqueeze(-1)).squeeze(-1)


class NDVariableCovarianceGaussian(Likelihood):
    """Multivariate Gaussian likelihood with a full covariance (or, with
    ``covariance=False``, precision) matrix per pixel, both inferred: its
    position is a pair ``(mean, mat)``, ``mean`` of the data's shape
    ``(..., d)`` and ``mat`` ``(..., d, d)`` symmetric positive definite.
    The matrix functions go through :mod:`.utils.tree_linalg` (one batched
    ``eigh`` of the ``(..., d, d)`` stack, Daleckii–Krein derivatives).
    The transformation is a local approximation; the metric and its left
    square root are the reference's closed forms."""

    def __init__(self, data, covariance: bool = True, device=None):
        super().__init__()
        self.register_buffer("data", _as_data(data, device))
        self.covariance = bool(covariance)

    @property
    def domain(self):
        d = self.data
        return (ShapeWithDtype.from_leave(d),
                ShapeWithDtype(tuple(d.shape) + (d.shape[-1],), d.dtype))

    @property
    def lsm_tangents_shape(self):
        return self.domain

    def _whiten(self, mat, x):
        """``mat⁻¹ x`` for a covariance, ``mat x`` for a precision."""
        return sym_solve(mat, x) if self.covariance else _matvec(mat, x)

    def energy(self, primals):
        mean, mat = primals
        rsdl = self.data - mean
        logdet = _sum(torch.linalg.slogdet(mat)[1])
        quad = 0.5 * _real_vdot(rsdl, self._whiten(mat, rsdl))
        return quad + 0.5 * logdet if self.covariance else quad - 0.5 * logdet

    def metric(self, primals, tangents):
        _, mat = primals
        t_mean, t_mat = tangents
        res_mat = sym_solve(mat, t_mat, matrix_eqn=True)
        res_mat = sym_solve(mat, res_mat, matrix_eqn=True, transposed=True)
        return (self._whiten(mat, t_mean), 0.5 * res_mat)

    def left_sqrt_metric(self, primals, tangents):
        _, mat = primals
        t_mean, t_mat = tangents
        sq = sym_sqrtm(mat)
        res_mat = sym_solve(sq, t_mat, matrix_eqn=True)
        res_mat = sym_solve(sq, res_mat, matrix_eqn=True, transposed=True)
        return (self._whiten(sq, t_mean), res_mat / math.sqrt(2.0))

    def transformation(self, primals):
        mean, mat = primals
        return (self._whiten(sym_sqrtm(mat), mean - self.data), 0.5 * sym_logm(mat))

    def normalized_residual(self, primals):
        mean, mat = primals
        return self._whiten(sym_sqrtm(mat), mean - self.data)
