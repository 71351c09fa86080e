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
  ``_raise_nonposdef``.  With ``batched=True`` it solves a forest of
  independent systems at once, each with its own scalars.

:func:`cg_steihaug` solves the trust-region subproblem of
:func:`~.optimize.trust_ncg` the same way: scalars on the device, the
iterate frozen by a mask once it stops, the flag read every
:data:`SYNC_EVERY` iterations.

The matrix-vector product is the device work of all of them.  A solve by
:func:`cg` or :func:`static_cg` is the span ``cg``, each of its products
the span ``cg.matvec`` (:mod:`.tracing`); :func:`static_cg` reads its
flag through :func:`~.tracing.host_read`.
"""

from __future__ import annotations

from functools import partial
from typing import Any, Callable, NamedTuple, Optional

import torch
from torch.utils._pytree import tree_leaves

from . import tracing
from .logger import logger
from .utils.tree import norm as tree_norm
from .utils.tree import (
    sample_norm,
    sample_vdot,
    size,
    tree_axpy,
    tree_map,
    vdot,
    where,
    zeros_like,
)

__all__ = ["CGResults", "SteihaugResults", "cg", "cg_steihaug", "static_cg"]

N_RESET = 20  # recompute the residual exactly every N iterations
SYNC_EVERY = 8  # static_cg: iterations between host reads of the stop flag


class CGResults(NamedTuple):
    x: Any
    nit: int
    nfev: int
    info: int
    success: bool


def _matvec(mat, x):
    with tracing.span("cg.matvec"):
        return mat(x)


@tracing.span("cg")
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
        r = tree_map(torch.sub, _matvec(mat, pos), j)
        energy = half_diff_dot(r, pos)
        nfev = 1
    d = r
    gamma_prev = float(vdot(r, r).real)
    if gamma_prev == 0.0:
        return CGResults(x=pos, nit=0, nfev=nfev, info=0, success=True)

    info = -1
    i = 0
    for i in range(1, maxiter + 1):
        q = _matvec(mat, d)
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
            r = tree_map(torch.sub, _matvec(mat, pos), j)
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


@tracing.span("cg")
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
    batched: bool = False,
    _raise_nonposdef: bool = False,
) -> CGResults:
    """Solve ``mat(x) = j`` with the scalars on the device; ``nit``,
    ``nfev``, ``info`` and ``success`` are 0-d tensors.  ``absdelta`` and
    ``resnorm`` may be 0-d tensors; ``name`` is taken for the host form's
    signature and logs nothing (logging would read the device).

    ``batched``: ``j`` (and ``x0``) are forests of B independent systems
    and ``mat`` applies each sample's matrix to its own sample (a
    ``torch.func.vmap`` of one matrix, say).  Every scalar is then a ``(B,)``
    tensor (``absdelta`` and ``resnorm`` may be too), a sample that stops is
    frozen by the mask while the others go on, and the loop ends once every
    sample has stopped: what ``jax.vmap`` makes of the JAX package's
    ``lax.while_loop``, so each sample's result is the one it gets alone."""
    dot, nrm = (sample_vdot, sample_norm) if batched else (vdot, tree_norm)
    leaf = tree_leaves(j)[0]
    lead = tuple(leaf.shape[:1]) if batched else ()
    norm_ord = 2 if norm_ord is None else norm_ord
    maxiter_fallback = 20 * (size(j) // (lead[0] if lead else 1))
    if miniter is None:
        miniter = min(6, maxiter if maxiter is not None else maxiter_fallback)
    if maxiter is None:
        maxiter = max(min(200, maxiter_fallback), miniter)
    if absdelta is None and resnorm is None:
        resnorm = torch.clamp_min(tol * nrm(j, ord=norm_ord), atol)
    finfo = torch.finfo(leaf.dtype)
    eps = 6.0 * finfo.eps
    tiny = 6.0 * finfo.tiny
    failed = -1 if _raise_nonposdef else 0

    def half_diff_dot(r, pos):
        return dot(tree_map(lambda a, b: (a - b) / 2, r, j), pos).real

    if x0 is None:
        pos = zeros_like(j)
        r = tree_map(torch.neg, j)
        energy = torch.zeros(lead, dtype=leaf.real.dtype, device=leaf.device)
    else:
        pos = x0
        r = tree_map(torch.sub, _matvec(mat, pos), j)
        energy = half_diff_dot(r, pos)
    d = r
    gamma = dot(r, r).real
    info = torch.where(gamma == 0.0, 0, -2).to(torch.int32)  # -2: keep iterating
    nit = torch.zeros(lead, dtype=torch.int32, device=leaf.device)

    for i in range(1, maxiter + 1):
        if i > 1 and (i - 1) % SYNC_EVERY == 0 and not tracing.host_read((info < -1).any()):
            break
        active = info < -1
        q = _matvec(mat, d)
        curv = dot(d, q).real
        bad_curv = curv <= 0.0
        new_info = torch.where(bad_curv, failed, info)
        alpha = torch.where(bad_curv, 0.0, gamma / curv)
        new_pos = tree_axpy(-alpha, d, pos)
        new_r = tree_axpy(-alpha, q, r)
        if i % N_RESET == 0:
            exact = tree_map(torch.sub, _matvec(mat, new_pos), j)
            new_r = where(new_info < -1, exact, new_r)
        new_gamma = dot(new_r, new_r).real
        ok = new_info != -1
        new_info = torch.where((new_gamma <= tiny) & ok, 0, new_info)
        if resnorm is not None and i >= miniter:
            rn = nrm(new_r, ord=norm_ord)
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
        pos, r, d, gamma, energy = where(
            active, (new_pos, new_r, new_d, new_gamma, new_energy), (pos, r, d, gamma, energy)
        )
        info = torch.where(active, new_info, info).to(torch.int32)
        nit = torch.where(active, i, nit).to(torch.int32)
    return CGResults(x=pos, nit=nit, nfev=nit, info=info, success=info == 0)


# --- the trust-region (Steihaug) subproblem --------------------------------------


class SteihaugResults(NamedTuple):
    step: Any
    hits_boundary: Any
    pred_f: Any
    nit: Any
    nhev: Any
    success: Any


def _tr_boundary_roots(z, d, trust_radius):
    """Both roots of ‖z + t d‖₂ = Δ, smaller first, without cancellation
    (the root of larger magnitude first, the other from the product)."""
    a = vdot(d, d).real
    b = 2.0 * vdot(z, d).real
    c = vdot(z, z).real - trust_radius**2
    disc = torch.sqrt(torch.clamp_min(b * b - 4.0 * a * c, 0.0))
    aux = b + torch.copysign(disc, b)
    ta = -aux / (2.0 * a)
    tb = -2.0 * c / aux
    return torch.minimum(ta, tb), torch.maximum(ta, tb)


def cg_steihaug(
    mat: Callable,
    j,
    *,
    trust_radius,
    cur_val=0.0,
    absdelta=None,
    resnorm=None,
    norm_ord=None,
    miniter: Optional[int] = None,
    maxiter: Optional[int] = None,
    name: Optional[str] = None,
) -> SteihaugResults:
    """Minimise the model m(p) = f + ⟨g, p⟩ + ½⟨p, B p⟩ subject to ‖p‖ ≤ Δ
    (``trust_radius``) by CG (Nocedal & Wright, algorithm 7.2), with the
    gradient ``j`` = g and ``mat`` = B: the counterpart of the JAX
    package's ``cg_steihaug``.  The returned ``step`` points downhill; the
    model values come from the CG invariant r = g + B z, so the only
    matrix products are one an iteration.  It stops in the interior
    (``resnorm``, ``absdelta`` after ``miniter``, or ``maxiter``), where
    the next iterate would cross the boundary (the step ends on it), or
    at a direction of non-positive curvature (the step walks to the
    boundary root of lower model value).  ``pred_f`` is ``cur_val`` plus
    the model's change; ``name`` is taken for the signature."""
    g = j
    norm_ord = 2 if norm_ord is None else norm_ord
    maxiter_fallback = 20 * size(g)
    if miniter is None:
        miniter = min(6, maxiter if maxiter is not None else maxiter_fallback)
    if maxiter is None:
        maxiter = max(min(200, maxiter_fallback), miniter)
    leaf = tree_leaves(g)[0]
    eps = 6.0 * torch.finfo(leaf.dtype).eps
    scalar = partial(torch.zeros, (), device=leaf.device)

    z = zeros_like(g)
    r, d, step = g, tree_map(torch.neg, g), z
    energy, pred = scalar(dtype=leaf.real.dtype), scalar(dtype=leaf.real.dtype)
    hits = done = scalar(dtype=torch.bool)
    nit = nhev = scalar(dtype=torch.int32)
    for i in range(1, maxiter + 1):
        if i > 1 and (i - 1) % SYNC_EVERY == 0 and bool(done):
            break
        active = ~done
        Bd = mat(d)
        dBd = vdot(d, Bd).real
        rd = vdot(r, d).real
        r2 = vdot(r, r).real
        alpha = r2 / dBd
        z_next = tree_axpy(alpha, d, z)
        r_next = tree_axpy(alpha, Bd, r)
        r2_next = vdot(r_next, r_next).real
        d_next = tree_axpy(r2_next / r2, d, tree_map(torch.neg, r_next))
        # the model at the next iterate through r = g + B z: m(z) - f = ½⟨r + g, z⟩
        energy_next = vdot(tree_map(lambda a, b: (a + b) / 2.0, r_next, g), z_next).real
        energy_diff = energy - energy_next
        rn = torch.sqrt(r2_next) if norm_ord == 2 else tree_norm(r_next, ord=norm_ord)
        interior = torch.full_like(done, i >= maxiter)
        if resnorm is not None:
            interior = interior | (rn < resnorm)
        if absdelta is not None and i >= miniter:
            interior = interior | (
                (energy_diff >= -eps * energy_next.abs()) & (energy_diff < absdelta)
            )
        neg_curv = dBd <= 0.0
        crosses = tree_norm(z_next, ord=2) >= trust_radius
        # the boundary along z + t d; the model there is m(z) + t⟨r, d⟩ + ½t²⟨d, B d⟩
        ta, tb = _tr_boundary_roots(z, d, trust_radius)
        m_ta = energy + ta * rd + 0.5 * ta * ta * dBd
        m_tb = energy + tb * rd + 0.5 * tb * tb * dBd
        t_neg = torch.where(m_ta < m_tb, ta, tb)
        cross = crosses & ~neg_curv
        new_step = where(interior, z_next, step)
        new_pred = torch.where(interior, energy_next, pred)
        new_step = where(cross, tree_axpy(tb, d, z), new_step)
        new_pred = torch.where(cross, m_tb, new_pred)
        new_step = where(neg_curv, tree_axpy(t_neg, d, z), new_step)
        new_pred = torch.where(neg_curv, torch.minimum(m_ta, m_tb), new_pred)
        stop = neg_curv | crosses | interior
        z, r, d, step, energy, pred, hits = where(
            active,
            (z_next, r_next, d_next, new_step, energy_next, new_pred,
             torch.where(stop, neg_curv | crosses, hits)),
            (z, r, d, step, energy, pred, hits),
        )
        nit = torch.where(active, i, nit).to(torch.int32)
        nhev = torch.where(active, nhev + 1, nhev).to(torch.int32)
        done = done | stop
    return SteihaugResults(
        step=step, hits_boundary=hits, pred_f=cur_val + pred, nit=nit, nhev=nhev,
        success=torch.ones((), dtype=torch.bool, device=leaf.device),
    )
