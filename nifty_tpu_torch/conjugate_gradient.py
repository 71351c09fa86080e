"""Conjugate gradient on trees of tensors (counterpart of
``nifty_tpu/conjugate_gradient.py``), in two forms with the same
convergence criteria:

- :func:`cg`, the host loop: each iteration reads its scalars (the
  curvature, the residual norm, the energy) back to the host and decides
  there, which lets it raise at once on a non-positive curvature;
- :func:`static_cg`, the counterpart of the JAX package's
  ``lax.while_loop`` form: the scalars and the stop flag stay on the
  device, an iteration after the stop changes nothing (every update is
  masked by the flag), and the host reads the flag only every
  :data:`SYNC_EVERY` iterations to end the loop early.  Its ``info`` codes
  are the JAX version's: 0 converged, ``i`` > 0 stopped at iteration i
  (the iteration limit, or a rising energy), -1 a failure under
  ``_raise_nonposdef``.

The matrix-vector product is the device work of both.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import torch
from torch.utils._pytree import tree_leaves

from .logger import logger
from .utils.tree import norm as tree_norm
from .utils.tree import size, tree_axpy, tree_map, vdot, zeros_like

__all__ = ["CGResults", "cg", "static_cg"]

N_RESET = 20  # recompute the residual exactly every N iterations
SYNC_EVERY = 8  # static_cg: iterations between host reads of the stop flag


class CGResults(NamedTuple):
    x: Any
    nit: int
    nfev: int
    info: int
    success: bool


def cg(
    mat: Callable,
    j,
    x0=None,
    *,
    absdelta=None,
    resnorm=None,
    norm_ord=None,
    tol: float = 1e-5,
    atol: float = 0.0,
    miniter: Optional[int] = None,
    maxiter: Optional[int] = None,
    name: Optional[str] = None,
    _raise_nonposdef: bool = True,
) -> CGResults:
    """Solve ``mat(x) = j`` for positive-definite ``mat``; ``name`` logs the
    residual norm of every iteration under that name."""
    norm_ord = 2 if norm_ord is None else norm_ord
    maxiter_fallback = 20 * size(j)
    if miniter is None:
        miniter = min(6, maxiter if maxiter is not None else maxiter_fallback)
    if maxiter is None:
        maxiter = max(min(200, maxiter_fallback), miniter)
    if absdelta is None and resnorm is None:
        resnorm = max(tol * float(tree_norm(j, ord=norm_ord)), atol)
    finfo = torch.finfo(tree_leaves(j)[0].dtype)
    eps = 6.0 * finfo.eps
    tiny = 6.0 * finfo.tiny

    def half_diff_dot(r, pos):
        return float(vdot(tree_map(lambda a, b: (a - b) / 2, r, j), pos).real)

    if x0 is None:
        pos = zeros_like(j)
        r = tree_map(torch.neg, j)
        energy = 0.0
        nfev = 0
    else:
        pos = x0
        r = tree_map(torch.sub, mat(pos), j)
        energy = half_diff_dot(r, pos)
        nfev = 1
    d = r
    gamma_prev = float(vdot(r, r).real)
    if gamma_prev == 0.0:
        return CGResults(x=pos, nit=0, nfev=nfev, info=0, success=True)

    info = -1
    i = 0
    for i in range(1, maxiter + 1):
        q = mat(d)
        nfev += 1
        curv = float(vdot(d, q).real)
        if curv == 0.0:
            if _raise_nonposdef:
                raise ValueError(f"{name or 'CG'}: zero curvature")
            info = 0
            break
        if curv < 0.0:
            if _raise_nonposdef:
                raise ValueError(f"{name or 'CG'}: negative curvature")
            if i == 1:
                pos = tree_map(lambda x: (gamma_prev / (-curv)) * (-x), j)
            info = 0
            break
        alpha = gamma_prev / curv
        pos = tree_axpy(-alpha, d, pos)
        if i % N_RESET == 0:
            r = tree_map(torch.sub, mat(pos), j)
            nfev += 1
        else:
            r = tree_axpy(-alpha, q, r)
        gamma = float(vdot(r, r).real)
        if 0.0 <= gamma <= tiny:
            info = 0
            break
        if resnorm is not None:
            rn = float(tree_norm(r, ord=norm_ord))
            if name is not None:
                logger.info(f"{name}: CG it {i} resnorm {rn:.3e}")
            if rn < resnorm and i >= miniter:
                info = 0
                break
        new_energy = half_diff_dot(r, pos)
        energy_diff = energy - new_energy
        if energy_diff < -eps * abs(new_energy):
            if _raise_nonposdef:
                raise ValueError(f"{name or 'CG'}: energy increased")
            info = i
            break
        if absdelta is not None and energy_diff < absdelta and i >= miniter:
            info = 0
            break
        energy = new_energy
        beta = max(0.0, gamma / gamma_prev)
        d = tree_axpy(beta, d, r)
        gamma_prev = gamma
    info = i if info == -1 else info
    return CGResults(x=pos, nit=i, nfev=nfev, info=info, success=info == 0)


def _masked(active, new, old):
    """``new`` where ``active`` (a 0-d bool tensor), else ``old``, leafwise."""
    return tree_map(lambda a, b: torch.where(active, a, b), new, old)


def static_cg(
    mat: Callable,
    j,
    x0=None,
    *,
    absdelta=None,
    resnorm=None,
    norm_ord=None,
    tol: float = 1e-5,
    atol: float = 0.0,
    miniter: Optional[int] = None,
    maxiter: Optional[int] = None,
    name: Optional[str] = None,
    _raise_nonposdef: bool = False,
) -> CGResults:
    """Solve ``mat(x) = j`` with the scalars on the device; ``nit``,
    ``nfev``, ``info`` and ``success`` are 0-d tensors.  ``absdelta`` and
    ``resnorm`` may be 0-d tensors; ``name`` is taken for the host form's
    signature and logs nothing (logging would read the device)."""
    norm_ord = 2 if norm_ord is None else norm_ord
    maxiter_fallback = 20 * size(j)
    if miniter is None:
        miniter = min(6, maxiter if maxiter is not None else maxiter_fallback)
    if maxiter is None:
        maxiter = max(min(200, maxiter_fallback), miniter)
    if absdelta is None and resnorm is None:
        resnorm = torch.clamp_min(tol * tree_norm(j, ord=norm_ord), atol)
    leaf = tree_leaves(j)[0]
    finfo = torch.finfo(leaf.dtype)
    eps = 6.0 * finfo.eps
    tiny = 6.0 * finfo.tiny
    failed = -1 if _raise_nonposdef else 0

    def half_diff_dot(r, pos):
        return vdot(tree_map(lambda a, b: (a - b) / 2, r, j), pos).real

    if x0 is None:
        pos = zeros_like(j)
        r = tree_map(torch.neg, j)
        energy = torch.zeros((), dtype=leaf.real.dtype, device=leaf.device)
    else:
        pos = x0
        r = tree_map(torch.sub, mat(pos), j)
        energy = half_diff_dot(r, pos)
    d = r
    gamma = vdot(r, r).real
    info = torch.where(gamma == 0.0, 0, -2).to(torch.int32)  # -2: keep iterating
    nit = torch.zeros((), dtype=torch.int32, device=leaf.device)

    for i in range(1, maxiter + 1):
        if i > 1 and (i - 1) % SYNC_EVERY == 0 and not bool(info < -1):
            break
        active = info < -1
        q = mat(d)
        curv = vdot(d, q).real
        bad_curv = curv <= 0.0
        new_info = torch.where(bad_curv, failed, info)
        alpha = torch.where(bad_curv, 0.0, gamma / curv)
        new_pos = tree_axpy(-alpha, d, pos)
        new_r = tree_axpy(-alpha, q, r)
        if i % N_RESET == 0:
            exact = tree_map(torch.sub, mat(new_pos), j)
            new_r = _masked(new_info < -1, exact, new_r)
        new_gamma = vdot(new_r, new_r).real
        ok = new_info != -1
        new_info = torch.where((new_gamma <= tiny) & ok, 0, new_info)
        if resnorm is not None and i >= miniter:
            rn = tree_norm(new_r, ord=norm_ord)
            new_info = torch.where((rn < resnorm) & ok, 0, new_info)
        new_energy = half_diff_dot(new_r, new_pos)
        energy_diff = energy - new_energy
        new_info = torch.where(
            energy_diff < -eps * new_energy.abs(), -1 if _raise_nonposdef else i, new_info
        )
        if absdelta is not None and i >= miniter:
            new_info = torch.where((energy_diff < absdelta) & (new_info != -1), 0, new_info)
        if i >= maxiter:
            new_info = torch.where(new_info != -1, i, new_info)
        new_d = tree_axpy(torch.clamp_min(new_gamma / gamma, 0.0), d, new_r)
        pos, r, d, gamma, energy = _masked(
            active, (new_pos, new_r, new_d, new_gamma, new_energy), (pos, r, d, gamma, energy)
        )
        info = torch.where(active, new_info, info).to(torch.int32)
        nit = torch.where(active, i, nit).to(torch.int32)
    return CGResults(x=pos, nit=nit, nfev=nit, info=info, success=info == 0)
