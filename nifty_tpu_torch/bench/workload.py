"""The bench's models as the port's entry points build them: ``bench.py``'s
metric-apply rows (exact and 64-knot) and ``bench_extra.py``'s VI rows,
the energy change of a leapfrog trajectory on a model's standardized
posterior, the models of ``chip_smoke.py``'s phase 12 (a Matérn
field, the density estimator's events, the full-covariance Gaussian's
forward model), phase 13's tomography (demo 1 at full width), phases
14-15's spherical and multi-grid fields, and phase 14a's library yardstick
for K5/K6 (a batched matrix product against a precomputed λ table)."""

from __future__ import annotations

__all__ = [
    "bench_field",
    "build_likelihood",
    "build_vi_likelihood",
    "density_counts",
    "gaussian_at_own_draw",
    "grid_index",
    "icr_fields",
    "latent_draw",
    "leapfrog_energy_change",
    "legendre_bmm_operands",
    "legendre_table",
    "matern_field",
    "ndvcg_forward",
    "poisson_at_own_draw",
    "sphere_field",
    "sphere_index",
    "tomography",
    "tomography_rays",
    "vi_settings",
]


def grid_index(full):
    """The exact correlated field's mode index of a Fourier grid of shape
    ``full`` (on the CPU), as ``finalize()`` builds it."""
    from nifty_tpu_torch.models.correlated_field import get_fourier_mode_distributor
    from nifty_tpu_torch.ops import mode_expand as me

    pd, um, _ = get_fourier_mode_distributor(tuple(full), 1.0)
    core = pd[tuple(slice(0, n // 2 + 1) for n in full)]
    return me.ExpandIndex(*me.build_expand_layout(core, um.size))


def sphere_index(nside):
    """The spherical correlated field's mode index (on the CPU), as
    ``finalize()`` builds it: the l of each packed alm, a flat 1-D layout."""
    import numpy as np

    from nifty_tpu_torch.models.correlated_field import make_grid
    from nifty_tpu_torch.ops import mode_expand as me

    hg = make_grid((nside,), None, "spherical").harmonic_grid
    pd = np.asarray(hg.power_distributor, dtype=np.int32)
    return me.ExpandIndex(*me.build_expand_layout(pd, int(hg.mode_lengths.size)))


def bench_field(n, device, dtype, n_mode_knots=None, field_mesh=None):
    """``bench.py``'s correlated field (``bench.py:78-88``) on an n² grid,
    exact or with ``n_mode_knots`` knots, finalized on ``device`` in
    ``dtype`` (row-sharded over ``field_mesh``'s axis "fx" when given)."""
    import nifty_tpu_torch as nt

    cfm = nt.CorrelatedFieldMaker("cf")
    cfm.set_amplitude_total_offset(offset_mean=1.0, offset_std=(1e-1, 3e-2))
    cfm.add_fluctuations(
        (n, n),
        distances=1.0 / n,
        fluctuations=(1.0, 5e-1),
        loglogavgslope=(-3.0, 2e-1),
        flexibility=(1e0, 2e-1),
        n_mode_knots=n_mode_knots,
    )
    return cfm.finalize(device=device, dtype=dtype, field_mesh=field_mesh)


def build_likelihood(n, device, dtype, seed=42, n_mode_knots=None, field_mesh=None):
    """``Poissonian(data).amend(ChainModel(exp, cf))`` with :func:`bench_field`;
    Poisson data, the latent position (both from ``seed``) and a tangent
    (from ``seed + 2``), the last two as numpy."""
    import numpy as np
    import torch

    import nifty_tpu_torch as nt

    cf = bench_field(n, device, dtype, n_mode_knots, field_mesh)
    rng = np.random.default_rng(seed)
    pos = {k: rng.standard_normal(v.shape) for k, v in sorted(cf.domain.items())}
    data = rng.poisson(1.0, size=(n, n)).astype(np.int32)
    if field_mesh is not None:  # the rank's rows of the data
        lo, rows = cf.rows
        data = data[lo : lo + rows]
    rng_t = np.random.default_rng(seed + 2)
    tan = {k: rng_t.standard_normal(v.shape) for k, v in sorted(cf.domain.items())}
    lh = nt.Poissonian(data, device=device).amend(nt.ChainModel(torch.exp, cf))
    return lh, pos, tan


def build_vi_likelihood(n, device, dtype, knots=64, field_mesh=None):
    """``bench_extra.py``'s VI model (``bench_extra.py:128-143``): Poisson
    counts drawn (numpy seed 1) at the rate of the model's own draw (its
    latent from numpy seed 0), and the starting position (numpy seed 2).
    Returns the likelihood and the start as numpy.  With ``field_mesh``
    the field is row-sharded and the data are the rank's rows of the
    unsharded model's counts."""
    import torch

    import nifty_tpu_torch as nt

    cf = bench_field(n, device, dtype, knots)
    fwd = nt.ChainModel(torch.exp, cf)
    counts = poisson_at_own_draw(fwd)
    if field_mesh is not None:
        cf = bench_field(n, device, dtype, knots, field_mesh)
        fwd = nt.ChainModel(torch.exp, cf)
        lo, rows = cf.rows
        counts = counts[lo : lo + rows]
    return nt.Poissonian(counts, device=device).amend(fwd), latent_draw(cf.domain, 2)


def poisson_at_own_draw(rate_model):
    """Poisson counts (numpy seed 1, int32) at the rate ``rate_model`` gives
    its own latent draw (numpy seed 0)."""
    import numpy as np
    import torch

    import nifty_tpu_torch as nt

    with torch.no_grad():
        rate = rate_model(nt.position_from_numpy(rate_model, latent_draw(rate_model.domain, 0)))
    rate = rate.double().cpu().numpy()
    return np.random.default_rng(1).poisson(np.clip(rate, 0, 1e6)).astype(np.int32)


def matern_field(n, device, dtype, pixel_expansion=False):
    """A renormalised Matérn field on an n² grid (the scale, cutoff and slope
    priors of the density estimator's defaults, ``bench.py``'s offset):
    the unique-|k| table form, or with ``pixel_expansion`` the per-pixel
    form."""
    import nifty_tpu_torch as nt

    cfm = nt.CorrelatedFieldMaker("mf")
    cfm.set_amplitude_total_offset(offset_mean=1.0, offset_std=(1e-1, 3e-2))
    cfm.add_fluctuations_matern((n, n), 1.0 / n, scale=(0.5, 0.3), cutoff=(4.0, 3.0),
                                loglogslope=(-6.0, 3.0), renormalize_amplitude=True,
                                pixel_expansion=pixel_expansion)
    return cfm.finalize(device=device, dtype=dtype)


def density_counts(shape, n_events, seed=5):
    """Event counts on ``shape`` bins of the unit square: ``n_events`` numpy
    draws of a mixture of two Gaussians (``demos/8_density_estimator.py``'s
    bimodal density, in 2-D), binned; int32."""
    import numpy as np

    rng = np.random.default_rng(seed)
    half = n_events // 2
    xy = np.concatenate([rng.normal((0.3, 0.35), (0.06, 0.08), (half, 2)),
                         rng.normal((0.7, 0.6), (0.1, 0.12), (n_events - half, 2))])
    counts, _, _ = np.histogram2d(xy[:, 0], xy[:, 1], bins=shape, range=((0, 1), (0, 1)))
    return counts.astype(np.int32)


def ndvcg_forward(cf, channels=5):
    """The ``(mean, mat)`` model of a full-covariance Gaussian on the grid of
    the correlated field ``cf``: a ``VModel`` of ``channels`` independent
    fields (every key mapped), the first two the mean ``(n0, n1, 2)``, the
    next three a symmetric 2×2 whose matrix exponential is the SPD matrix
    ``(n0, n1, 2, 2)``."""
    import torch

    import nifty_tpu_torch as nt

    fields = nt.VModel(cf, channels)

    def to_pair(f):
        a, b, c = 0.3 * f[2], 0.3 * f[3], 0.3 * f[4]
        s = torch.stack([torch.stack([a, b], -1), torch.stack([b, c], -1)], -2)
        return torch.stack([f[0], f[1]], -1), torch.linalg.matrix_exp(s)

    return nt.ChainModel(to_pair, fields)


def latent_draw(domain, seed):
    """Standard normals over ``domain`` from numpy ``seed``, key by key in
    sorted order (a key of per-level leaves, an ICR field's, level by
    level): :func:`build_vi_likelihood`'s latent draws (seed 0 made its
    data)."""
    import numpy as np

    rng = np.random.default_rng(seed)

    def draw(v):
        return [rng.standard_normal(s.shape) for s in v] if isinstance(v, list) else \
            rng.standard_normal(v.shape)

    return {k: draw(v) for k, v in sorted(domain.items())}


def leapfrog_energy_change(likelihood, position, momentum, step_size, n_steps):
    """``(H(end) - H(start), end positions, end momenta)`` of ``n_steps``
    leapfrog steps of the standardized posterior of ``likelihood``
    (``nt.LogDensity``) with a unit mass matrix, from the forests
    ``position`` and ``momentum`` (a leading chain axis), every chain in
    one batch through ``Potential``: ΔH a float64 numpy array, a chain
    each, H in float64; ``step_size`` a number or one a chain."""
    import torch

    import nifty_tpu_torch as nt
    from nifty_tpu_torch.hmc import QP
    from nifty_tpu_torch.hmc_oo import Potential, Ravel, kinetic_energy, make_stepper

    ravel = Ravel({k: v[0] for k, v in position.items()})
    potential = Potential(lambda x: -nt.LogDensity(likelihood)(x), ravel)
    qp = QP(ravel.ravel(position), ravel.ravel(momentum))
    inv_m = torch.ones_like(qp.position)
    step_size = torch.as_tensor(step_size, dtype=torch.float64, device=qp.position.device)

    def hamiltonian(qp):
        h = potential.energy(qp.position).double() + kinetic_energy(inv_m, qp.momentum)
        return h.cpu().numpy()

    h0, step = hamiltonian(qp), make_stepper(potential)
    for _ in range(n_steps):
        qp = step(step_size, inv_m, qp)
    return hamiltonian(qp) - h0, ravel.unravel(qp.position), ravel.unravel(qp.momentum)


def vi_settings():
    """``bench_extra.py``'s VI iteration (``bench_extra.py:146-264``) as
    :meth:`OptimizeVI.init_state` keywords: 2 mirrored sample pairs, the
    draw's static CG 20 iterations, geoVI's Newton-CG 2 steps of CG 5, the
    KL one static Newton step of CG 10; ``sample_mode`` is the caller's."""
    import nifty_tpu_torch as nt

    fixed = lambda n: dict(maxiter=n, miniter=n, resnorm=-1.0)  # noqa: E731
    return dict(
        n_samples=2,
        draw_linear_kwargs=dict(cg=nt.static_cg, cg_kwargs=fixed(20)),
        nonlinearly_update_kwargs=dict(
            minimize_kwargs=dict(maxiter=2, xtol=-1.0, cg_kwargs=fixed(5))
        ),
        kl_kwargs=dict(
            minimize=nt.static_newton_cg, minimize_kwargs=dict(maxiter=1, cg_kwargs=fixed(10))
        ),
    )


def short_vi_settings(steps=3):
    """:func:`vi_settings` with the draw's CG and the KL's one Newton step of
    CG cut to ``steps`` iterations: the comparisons of two runs that round
    differently (sharded and unsharded) stop there, since CG past
    convergence amplifies rounding without bound."""
    import nifty_tpu_torch as nt

    fixed = dict(maxiter=steps, miniter=steps, resnorm=-1.0)
    return dict(vi_settings(), draw_linear_kwargs=dict(cg=nt.static_cg, cg_kwargs=fixed),
                kl_kwargs=dict(minimize=nt.static_newton_cg,
                               minimize_kwargs=dict(maxiter=1, cg_kwargs=fixed)))


def tomography_rays(n_rays, seed=41):
    """Demo 1's rays: from the left edge of the unit square (x = 0) to the
    right one (x = 1), start and end heights uniform (numpy ``seed``);
    ``(starts, ends)``, each ``(n_rays, 2)``."""
    import numpy as np

    rng = np.random.default_rng(seed)
    starts = np.stack([np.zeros(n_rays), rng.uniform(size=n_rays)], axis=1)
    ends = np.stack([np.ones(n_rays), rng.uniform(size=n_rays)], axis=1)
    return starts, ends


def tomography(n, n_rays, device, noise=1e-2):
    """Demo 1 at n²: :func:`bench_field` (exact), ``exp``, then
    ``ExactGridLOS`` over :func:`tomography_rays`, under a Gaussian whose
    data are the model's own draw (latent numpy seed 0) plus ``noise``
    times the mean integral (numpy seed 1).  Returns the float32
    likelihood on ``device``, the float64 one on the CPU over the same
    numpy tables (built once, then copied), the start (numpy seed 2) and
    the seconds the tables took."""
    import copy
    import time

    import numpy as np
    import torch

    import nifty_tpu_torch as nt

    starts, ends = tomography_rays(n_rays)
    t0 = time.perf_counter()
    los64 = nt.ExactGridLOS(starts, ends, shape=(n, n), distances=1.0 / n, device="cpu",
                            dtype=torch.float64)
    table_s = time.perf_counter() - t0
    los32 = copy.deepcopy(los64).to(device, torch.float32)
    fwd64 = nt.ChainModel(los64, nt.ChainModel(torch.exp, bench_field(n, "cpu", torch.float64)))
    fwd32 = nt.ChainModel(los32, nt.ChainModel(torch.exp, bench_field(n, device, torch.float32)))
    with torch.no_grad():
        line = fwd64(nt.position_from_numpy(fwd64, latent_draw(fwd64.domain, 0))).numpy()
    std = noise * float(line.mean())
    data = line + std * np.random.default_rng(1).standard_normal(line.shape)
    lh64 = nt.Gaussian(data, noise_cov_inv=1.0 / std**2, device="cpu").amend(fwd64)
    lh32 = nt.Gaussian(data.astype(np.float32), noise_cov_inv=1.0 / std**2, device=device).amend(fwd32)
    return lh32, lh64, latent_draw(fwd32.domain, 2), table_s


def sphere_field(nside, device, dtype, regular=None):
    """``bench_extra.py:98-125``'s spherical correlated field (HEALPix,
    lmax 2 nside); with ``regular``, its outer product with a regular axis
    of that many pixels (the synthesis over the sphere's axis, the Hartley
    over the other)."""
    import nifty_tpu_torch as nt

    cfm = nt.CorrelatedFieldMaker("sky")
    cfm.set_amplitude_total_offset(offset_mean=0.0, offset_std=(1e-1, 3e-2))
    cfm.add_fluctuations((nside,), distances=None, fluctuations=(1.0, 5e-1),
                         loglogavgslope=(-3.0, 2e-1), flexibility=(1e0, 2e-1),
                         harmonic_type="spherical")
    if regular:
        cfm.add_fluctuations((regular,), distances=1.0 / regular, fluctuations=(1.0, 5e-1),
                             loglogavgslope=(-2.0, 2e-1), prefix="r")
    return cfm.finalize(device=device, dtype=dtype)


def legendre_table(plan):
    """λ_{l,m}(θ_r) of ``plan`` (a ``cuda_legendre.LegendrePlan``) as one
    float32 table (mmax+1, 2 Rh, lmax+1), zero where l < m: rows r < Rh the
    northern rings, rows Rh + r their mirrors, signed by (-1)^(l+m).  One
    ``torch.bmm`` of it with the coefficients computes K5, one of its
    transpose with the cotangents K6: the library yardstick of
    ``chip_smoke.py`` phase 14a (contraction only, the table precomputed)."""
    import numpy as np
    import torch

    from ..ops import cuda_legendre as cl

    lam = torch.stack([row for _, row in cl._lambda_rows(plan)], dim=2)  # (Rh, M, L) float64
    lam = lam.permute(1, 0, 2)
    L, M = plan.lmax + 1, plan.mmax + 1
    sign = torch.from_numpy((-1.0) ** np.add.outer(np.arange(M), np.arange(L))).to(lam.device)
    return torch.cat([lam, lam * sign[:, None, :]], dim=1).to(torch.float32)


def legendre_bmm_operands(plan, alm, cot):
    """The other operands of :func:`legendre_table`'s products, and how to
    read them back: ``c`` (mmax+1, lmax+1, 2 B), the packed ``alm`` (B,
    size) unpacked; ``G`` (mmax+1, 2 Rh, 2 B), the cotangent ``cot`` (B, R,
    mmax+1, 2) by ring as the table's rows (zero for a mirror that is no
    ring of its own); ``ring_side(F)`` turns ``bmm(table, c)`` into K5's
    (B, R, mmax+1, 2) and ``packed(g)`` ``bmm(table.transpose(1, 2), G)``
    into K6's (B, size)."""
    import torch

    B, Rh, R = alm.shape[0], plan.n_half, plan.n_rings
    dense = torch.cat([alm, alm.new_zeros(B, 1)], dim=1)[:, plan.unpack_index]  # (B, L, M, 2)
    c = dense.permute(2, 1, 0, 3).reshape(plan.mmax + 1, plan.lmax + 1, 2 * B)
    south = torch.cat([cot[:, Rh:].flip(1), cot.new_zeros((B, 2 * Rh - R) + cot.shape[2:])], dim=1)
    G = torch.cat([cot[:, :Rh], south], dim=1).permute(2, 1, 0, 3).reshape(plan.mmax + 1, 2 * Rh, 2 * B)

    def ring_side(F):
        F = F.reshape(plan.mmax + 1, 2 * Rh, B, 2).permute(2, 1, 0, 3)
        return torch.cat([F[:, :Rh], F[:, Rh:Rh + R - Rh].flip(1)], dim=1)

    def packed(g):
        dense_g = g.reshape(plan.mmax + 1, plan.lmax + 1, B, 2).permute(2, 1, 0, 3)
        return dense_g.reshape(B, -1)[:, plan.pack_index]

    return c, G, ring_side, packed


def gaussian_at_own_draw(model32, model64, noise, device, seed=1):
    """Gaussian likelihoods of ``model32`` (float32 on ``device``) and of its
    float64 twin ``model64`` (on the CPU; ``model32`` itself where no twin is
    needed) whose data are ``model64`` at its own latent draw (numpy seed 0)
    plus ``noise`` times standard normals (numpy ``seed``)."""
    import numpy as np
    import torch

    import nifty_tpu_torch as nt

    with torch.no_grad():
        truth = model64(nt.position_from_numpy(model64, latent_draw(model64.domain, 0)))
    truth = truth.double().cpu().numpy()
    data = truth + noise * np.random.default_rng(seed).standard_normal(truth.shape)
    lh32 = nt.Gaussian(data.astype(np.float32), noise_cov_inv=1.0 / noise**2,
                       device=device).amend(model32)
    return lh32, nt.Gaussian(data, noise_cov_inv=1.0 / noise**2, device="cpu").amend(model64)


def icr_fields(device, depth=6):
    """``bench_extra.py:305``'s ICR field (a 16² open grid, ``depth``
    refinements, padding 1, the fixed covariance exp(-r²/(2·0.1²))) and
    demo 4's learned Matérn field on the same grid, each in float64 on the
    CPU and copied in float32 to ``device``: ``{name: (card, cpu64,
    build seconds)}``.  The Matérn table starts at r = 1e-3, not demo 4's
    0.05: at depth 6 the stencils' distances go down to 1/64, and a table
    clamped below 0.05 makes their covariances (near-)singular."""
    import copy
    import time

    import torch

    from nifty_tpu_torch import multi_grid as mg

    def fixed(**kw):
        return mg.ICRField(mg.SimpleOpenGrid(shape0=(16, 16), depth=depth, padding=1),
                           lambda r: torch.exp(-0.5 * (r / 0.1) ** 2), **kw)

    def matern(**kw):
        cov = mg.MaternCovarianceModel(ndim=2, r_min=1e-3, r_max=20.0, scale=(1.0, 0.3),
                                       cutoff=(2.0, 0.5), loglogslope=(-3.5, 0.5),
                                       n_integrate=600, n_interpolate=128)
        return mg.ICRField(mg.SimpleOpenGrid(shape0=(16, 16), depth=depth, padding=1), cov, **kw)

    out = {}
    for name, build in (("fixed", fixed), ("matern", matern)):
        t0 = time.perf_counter()
        f64 = build(device="cpu", dtype=torch.float64)
        out[name] = (copy.deepcopy(f64).to(device, torch.float32), f64, time.perf_counter() - t0)
    return out
