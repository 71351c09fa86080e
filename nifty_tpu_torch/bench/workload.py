"""The exact-spectrum row of ``bench.py`` as the port's entry points build it."""

from __future__ import annotations

__all__ = ["build_likelihood", "grid_index"]


def grid_index(full):
    """The exact correlated field's mode index of a Fourier grid of shape
    ``full`` (on the CPU), as ``finalize()`` builds it."""
    from nifty_tpu_torch.models.correlated_field import get_fourier_mode_distributor
    from nifty_tpu_torch.ops import mode_expand as me

    pd, um, _ = get_fourier_mode_distributor(tuple(full), 1.0)
    core = pd[tuple(slice(0, n // 2 + 1) for n in full)]
    return me.ExpandIndex(*me.build_expand_layout(core, um.size))


def build_likelihood(n, device, dtype, seed=42):
    """``Poissonian(data).amend(ChainModel(exp, cf))`` with ``bench.py``'s
    correlated field (``bench.py:78-88``) on an n² grid, built by the entry
    points on ``device`` in ``dtype``; Poisson data, the latent position
    (both from ``seed``) and a tangent (from ``seed + 2``), the last two as
    numpy."""
    import numpy as np
    import torch

    import nifty_tpu_torch as nt

    cfm = nt.CorrelatedFieldMaker("cf")
    cfm.set_amplitude_total_offset(offset_mean=1.0, offset_std=(1e-1, 3e-2))
    cfm.add_fluctuations(
        (n, n),
        distances=1.0 / n,
        fluctuations=(1.0, 5e-1),
        loglogavgslope=(-3.0, 2e-1),
        flexibility=(1e0, 2e-1),
    )
    cf = cfm.finalize(device=device, dtype=dtype)
    rng = np.random.default_rng(seed)
    pos = {k: rng.standard_normal(v.shape) for k, v in sorted(cf.domain.items())}
    data = rng.poisson(1.0, size=(n, n)).astype(np.int32)
    rng_t = np.random.default_rng(seed + 2)
    tan = {k: rng_t.standard_normal(v.shape) for k, v in sorted(cf.domain.items())}
    lh = nt.Poissonian(data, device=device).amend(nt.ChainModel(torch.exp, cf))
    return lh, pos, tan
