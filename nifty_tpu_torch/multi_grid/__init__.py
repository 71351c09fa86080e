"""Multi-grid Gaussian processes by iterative charted refinement (ICR):
regular, log-radial and product charts, the HEALPix sphere and the sphere
× log-radius chart (counterpart of ``nifty_tpu/multi_grid``)."""

from .correlated_field import ICRField
from .grid import BrokenLogGrid, Grid, LogGrid, MGrid, SimpleOpenGrid
from .healpix_grid import HEALPixICRField, HEALPixICRKernel, HEALPixRefinementGrid
from .kernel import ICRKernel, apply_kernel
from .matern import MaternCovarianceModel, matern_spectral_covariance
from .sphere_radius import SphereLogRadiusGrid, SphereRadiusICRField, SphereRadiusICRKernel
