"""nifty_tpu_torch: the PyTorch and CUDA port of nifty_tpu.

Slice 1: the exact-spectrum correlated field, the Poisson and Gaussian
likelihoods with their Fisher metrics, and conjugate gradient, running on
one NVIDIA H100 through hand-written CUDA kernels (``csrc/``) for the
mode-table expansion (K1), its adjoint (K2) and the 2-D Hartley (K3 + K4).
On CPU tensors every kernel wrapper runs its plain PyTorch version.

The package imports torch and never jax.
"""

from . import config
from .conjugate_gradient import CGResults, cg
from .interop import position_from_numpy
from .likelihood import Likelihood, LikelihoodWithModel
from .likelihood_impl import Gaussian, Poissonian
from .model import ChainModel, Initializer, Model, WrappedCall
from .models.correlated_field import (
    CorrelatedField,
    CorrelatedFieldMaker,
    NonParametricAmplitude,
    get_fourier_mode_distributor,
    make_grid,
)
from .models.gauss_markov import IntegratedWienerProcess, integrated_wiener_process
from .num.stats_distributions import lognormal_moments, lognormal_prior, normal_prior
from .ops.fft import hartley
from .utils.tree import ShapeWithDtype, Vector, norm, random_like, tree_axpy, vdot, zeros_like
