"""Conjugate gradient on trees of tensors, host-loop form (counterpart of
``nifty_tpu/conjugate_gradient.py:cg``).

Each iteration reads two scalars back to the host (the curvature and the
residual norm), which lets the caller stop early; the matrix-vector
product is the device work.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import torch
from torch.utils._pytree import tree_leaves

from .utils.tree import norm as tree_norm
from .utils.tree import size, tree_axpy, tree_map, vdot, zeros_like

__all__ = ["CGResults", "cg"]

N_RESET = 20  # recompute the residual exactly every N iterations


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
    _raise_nonposdef: bool = True,
) -> CGResults:
    """Solve ``mat(x) = j`` for positive-definite ``mat``."""
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
                raise ValueError("CG: zero curvature")
            info = 0
            break
        if curv < 0.0:
            if _raise_nonposdef:
                raise ValueError("CG: negative curvature")
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
            if rn < resnorm and i >= miniter:
                info = 0
                break
        new_energy = half_diff_dot(r, pos)
        energy_diff = energy - new_energy
        if energy_diff < -eps * abs(new_energy):
            if _raise_nonposdef:
                raise ValueError("CG: energy increased")
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
