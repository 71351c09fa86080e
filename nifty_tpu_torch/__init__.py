"""nifty_tpu_torch: the PyTorch and CUDA port of nifty_tpu.

The correlated field in its exact and 64-knot forms, the Poisson and
Gaussian likelihoods with their Fisher metrics, conjugate gradient,
Newton-CG and the MGVI/geoVI loop (``optimize_kl``), running on one NVIDIA
H100 through hand-written CUDA kernels (``csrc/``) for the mode-table
expansion (K1), its adjoint (K2) and the 2-D Hartley (K3 + K4).  On CPU
tensors every kernel wrapper runs its plain PyTorch version.

The package imports torch and never jax.
"""

from . import config
from .conjugate_gradient import CGResults, cg, static_cg
from .evi import (
    Samples,
    WhiteNoise,
    concatenate_zip,
    draw_linear_residual,
    draw_residual,
    nonlinearly_update_residual,
    sample_likelihood,
    white_noise,
)
from .interop import position_from_numpy, samples_from_numpy
from .likelihood import Likelihood, LikelihoodPartial, LikelihoodWithModel, StandardHamiltonian
from .likelihood_impl import Gaussian, Poissonian
from .minisanity import ChiSqStats, minisanity, reduced_residual_stats
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
from .optimize import OptimizeResults, minimize, newton_cg, static_newton_cg
from .optimize_kl import OptimizeVI, OptimizeVIState, optimize_kl
from .utils.tree import (
    ShapeWithDtype,
    Vector,
    get_map,
    lmap,
    mean,
    mean_and_std,
    norm,
    random_like,
    stack,
    tree_axpy,
    unstack,
    vdot,
    zeros_like,
)
