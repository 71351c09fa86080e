"""nifty_tpu_torch: the PyTorch and CUDA port of nifty_tpu.

The correlated field in its exact and 64-knot forms, with Matérn spectra
(table or per-pixel) and the density estimator, the prior families and
the Gauss-Markov processes, the model combinators (``LazyModel``,
``VModel``, ``ClipModel``, ``RematModel``), the likelihoods (Gaussian,
Poisson, Student-t, Bernoulli, categorical, inverse-gamma, the
variable-covariance ones with the full per-pixel covariance, and their
sums) with their Fisher metrics, parametric VI (mean-field and
full-covariance, fitted by ``torch.optim``),
HMC and NUTS with chains batched on a leading axis, conjugate gradient,
Newton-CG, trust-region Newton-CG, the MGVI/geoVI loop (``optimize_kl``,
samples mapped as one batch by default), the Wiener filter and the
evidence lower bound (Lanczos), the responses (exact and sampled
line-of-sight integrals, the NUFFT, structured kernel interpolation), the
dynamics priors, the structural operators (``operators``) and the
consistency checks (``extra``), the diagnostics (probing, operator
spectra, empirical power spectra, ``check_model``, ``adjust_variances``)
and the output (``io``, ``plot``, config files), running on one NVIDIA H100 through
hand-written CUDA kernels (``csrc/``) for the mode-table expansion (K1),
its adjoint (K2) and the 2-D Hartley (K3 + K4), each batched over the
samples under ``torch.func.vmap``.  On CPU tensors every kernel wrapper
runs its plain PyTorch version.

The package imports torch and never jax.
"""

from . import config, extra, hmc, io, multi_grid, operators, plot
from .adjust_variances import adjust_variances
from .check_model import check_model
from .config_file import OptimizeKLConfig
from .conjugate_gradient import CGResults, SteihaugResults, cg, cg_steihaug, static_cg
from .evi import (
    Samples,
    WhiteNoise,
    concatenate_zip,
    draw_linear_residual,
    draw_linear_residuals,
    draw_residual,
    nonlinearly_update_residual,
    nonlinearly_update_residuals,
    sample_likelihood,
    white_noise,
    wiener_filter_posterior,
)
from .empirical_power_spectrum import compute_empirical_power_spectrum
from .evidence_lower_bound import estimate_evidence_lower_bound
from .interop import params_from_numpy, position_from_numpy, samples_from_numpy
from .hmc import generate_hmc_acc_rej, generate_nuts_tree
from .hmc_oo import Chain, HMCChain, NUTSChain
from .los import ExactGridLOS, SamplingCartesianGridLOS
from .likelihood import (
    Likelihood,
    LikelihoodPartial,
    LikelihoodSum,
    LikelihoodWithModel,
    StandardHamiltonian,
    partial_insert_and_remove,
)
from .likelihood_impl import (
    Bernoulli,
    Categorical,
    Gaussian,
    InverseGamma,
    NDVariableCovarianceGaussian,
    Poissonian,
    StudentT,
    VariableCovarianceGaussian,
    VariableCovarianceStudentT,
)
from .logger import logger
from .mcmc import LogDensity, get_sample_size_estimate, nuts_sample
from .minisanity import ChiSqStats, minisanity, reduced_residual_stats
from .model import (
    ChainModel,
    ClipModel,
    Initializer,
    LazyModel,
    Model,
    RematModel,
    VModel,
    WrappedCall,
)
from .models.correlated_field import (
    CorrelatedField,
    CorrelatedFieldMaker,
    MaternAmplitude,
    NonParametricAmplitude,
    density_estimator,
    get_fourier_mode_distributor,
    get_spherical_mode_distributor,
    make_grid,
)
from .models.gauss_markov import (
    GaussMarkovProcess,
    IntegratedWienerProcess,
    OrnsteinUhlenbeckProcess,
    WienerProcess,
    discrete_gauss_markov_process,
    integrated_wiener_process,
    ornstein_uhlenbeck_process,
    wiener_process,
)
from .models.dynamics import (
    dynamic_lightcone_operator,
    dynamic_operator,
    light_cone,
)
from .models.prior import (
    BetaPrior,
    GammaPrior,
    InvGammaPrior,
    LaplacePrior,
    LogInvGammaPrior,
    LogNormalPrior,
    NormalPrior,
    UniformPrior,
)
from .num.lanczos import lanczos_tridiag, stochastic_logdet_from_lanczos, stochastic_lq_logdet
from .num.stats_distributions import (
    beta_prior,
    gamma_prior,
    interpolator,
    invgamma_invprior,
    invgamma_prior,
    laplace_prior,
    loginvgamma_prior,
    lognormal_invprior,
    lognormal_moments,
    lognormal_prior,
    normal_invprior,
    normal_prior,
    uniform_prior,
)
from .ops.fft import hartley
from .ops.nufft import nufft1, nufft2, nufft_adjoint
from .optimize import (
    OptimizeResults,
    minimize,
    newton_cg,
    optim_wrapper,
    static_newton_cg,
    trust_ncg,
)
from .operator_spectrum import operator_spectrum
from .optimize_kl import OptimizeVI, OptimizeVIState, optimize_kl
from .probing import StatCalculator, probe_diagonal, probe_with_posterior_samples
from .ski import HarmonicSKI, ToeplitzSKI, interp_mat, matmul_toeplitz
from .utils.misc import hvp, interpolate, wrap, wrap_left
from .utils.pytree_string import PyTreeString, hide_strings
from .utils.tree import (
    ShapeWithDtype,
    Vector,
    assert_arithmetics,
    dot,
    get_map,
    lmap,
    map_forest,
    map_forest_mean,
    mean,
    mean_and_std,
    norm,
    ones_like,
    random_like,
    sample_norm,
    sample_vdot,
    smap,
    stack,
    tree_axpy,
    unstack,
    vdot,
    vmap,
    where,
    zeros_like,
)
from .utils.tree_linalg import sym_inv, sym_logm, sym_solve, sym_sqrtm
from .variational_models import FullCovarianceVI, MeanFieldVI
