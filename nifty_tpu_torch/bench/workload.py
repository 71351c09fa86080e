"""The bench's models as the port's entry points build them: ``bench.py``'s
metric-apply rows (exact and 64-knot) and ``bench_extra.py``'s VI rows."""

from __future__ import annotations

__all__ = ["bench_field", "build_likelihood", "build_vi_likelihood", "grid_index", "vi_settings"]


def grid_index(full):
    """The exact correlated field's mode index of a Fourier grid of shape
    ``full`` (on the CPU), as ``finalize()`` builds it."""
    from nifty_tpu_torch.models.correlated_field import get_fourier_mode_distributor
    from nifty_tpu_torch.ops import mode_expand as me

    pd, um, _ = get_fourier_mode_distributor(tuple(full), 1.0)
    core = pd[tuple(slice(0, n // 2 + 1) for n in full)]
    return me.ExpandIndex(*me.build_expand_layout(core, um.size))


def bench_field(n, device, dtype, n_mode_knots=None):
    """``bench.py``'s correlated field (``bench.py:78-88``) on an n² grid,
    exact or with ``n_mode_knots`` knots, finalized on ``device`` in
    ``dtype``."""
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
    return cfm.finalize(device=device, dtype=dtype)


def build_likelihood(n, device, dtype, seed=42, n_mode_knots=None):
    """``Poissonian(data).amend(ChainModel(exp, cf))`` with :func:`bench_field`;
    Poisson data, the latent position (both from ``seed``) and a tangent
    (from ``seed + 2``), the last two as numpy."""
    import numpy as np
    import torch

    import nifty_tpu_torch as nt

    cf = bench_field(n, device, dtype, n_mode_knots)
    rng = np.random.default_rng(seed)
    pos = {k: rng.standard_normal(v.shape) for k, v in sorted(cf.domain.items())}
    data = rng.poisson(1.0, size=(n, n)).astype(np.int32)
    rng_t = np.random.default_rng(seed + 2)
    tan = {k: rng_t.standard_normal(v.shape) for k, v in sorted(cf.domain.items())}
    lh = nt.Poissonian(data, device=device).amend(nt.ChainModel(torch.exp, cf))
    return lh, pos, tan


def build_vi_likelihood(n, device, dtype, knots=64):
    """``bench_extra.py``'s VI model (``bench_extra.py:128-143``): Poisson
    counts drawn (numpy seed 1) at the rate of the model's own draw (its
    latent from numpy seed 0), and the starting position (numpy seed 2).
    Returns the likelihood and the start as numpy."""
    import numpy as np
    import torch

    import nifty_tpu_torch as nt

    cf = bench_field(n, device, dtype, knots)
    fwd = nt.ChainModel(torch.exp, cf)

    def draw(seed):
        rng = np.random.default_rng(seed)
        return {k: rng.standard_normal(v.shape) for k, v in sorted(cf.domain.items())}

    with torch.no_grad():
        rate = fwd(nt.position_from_numpy(cf, draw(0))).double().cpu().numpy()
    data = np.random.default_rng(1).poisson(np.clip(rate, 0, 1e6)).astype(np.int32)
    return nt.Poissonian(data, device=device).amend(fwd), draw(2)


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
