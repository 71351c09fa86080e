"""Standard likelihoods (counterpart of the Poisson and Gaussian
likelihoods of ``nifty_tpu/likelihood_impl.py``).  Data are one tensor:
a tensor stays on its device unless ``device`` is given; other data (numpy
arrays, lists) go to ``device``, the CUDA card by default."""

from __future__ import annotations

from typing import Callable, Optional, Union

import torch

from . import device as _device
from .likelihood import Likelihood

__all__ = ["Gaussian", "Poissonian"]


def _as_data(data, device):
    if isinstance(data, torch.Tensor):
        return data if device is None else data.to(device)
    return torch.as_tensor(data, device=_device.resolve(device))


class Gaussian(Likelihood):
    """Gaussian likelihood with fixed noise covariance:
    E(f) = ½ (d-f)ᵀ N⁻¹ (d-f), transformation(f) = N^{-1/2} f.

    ``noise_cov_inv`` and ``noise_std_inv`` are callables or diagonal
    weights; a missing one follows from the other for a diagonal
    covariance; with neither the noise is white."""

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
        as_t = lambda w: torch.as_tensor(w, device=data.device)
        cov, std = noise_cov_inv, noise_std_inv
        if cov is not None or std is not None:
            ones = torch.ones_like(data.real)
            if cov is None:
                cov = (std(ones) if callable(std) else as_t(std) * ones) ** 2
            if std is None:
                std = torch.sqrt(cov(ones) if callable(cov) else as_t(cov) * ones)
        self._cov_fn = cov if callable(cov) else None
        self._std_fn = std if callable(std) else None
        self.register_buffer("cov_weight", None if cov is None or callable(cov) else as_t(cov))
        self.register_buffer("std_weight", None if std is None or callable(std) else as_t(std))

    @staticmethod
    def _apply(fn, weight, x):
        if fn is not None:
            return fn(x)
        return x if weight is None else weight * x

    def noise_cov_inv(self, x):
        return self._apply(self._cov_fn, self.cov_weight, x)

    def noise_std_inv(self, x):
        return self._apply(self._std_fn, self.std_weight, x)

    def energy(self, primals):
        res = self.data - primals
        return 0.5 * torch.sum(res * self.noise_cov_inv(res))

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
        return torch.sum(primals) - torch.sum(torch.log(primals) * self.data)

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
