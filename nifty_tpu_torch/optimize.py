"""Newton-CG minimisers (counterpart of ``nifty_tpu/optimize.py``).

Both take ``fun_and_grad`` (or ``fun``, differentiated with
``torch.func``) and ``hessp(x, t)``, a Hessian or metric applied to t at x.
Each Newton step solves ``hessp(x) d = grad`` by CG, with a forcing term
from the last energy decrease (``energy_reduction_factor``) and a residual
norm from the gradient's, then searches along ``-d`` by successive
halving, turning to steepest descent after 5 failed halvings.

- :func:`newton_cg` runs the host-loop :func:`~.conjugate_gradient.cg`
  and stops a failed line search with a warning;
- :func:`static_newton_cg` follows the JAX package's ``lax`` form: CG is
  :func:`~.conjugate_gradient.static_cg`, a failed line search keeps the
  position and reports status -1, and the forcing term falls back to
  ``absdelta / 100`` (or none) while no earlier energy is known.

A line search reads each trial's energy on the host; that is one device
read per energy evaluation, which the search needs anyway.
``trust_ncg`` and ``optax_wrapper`` are not ported (ROADMAP.md, section A).
"""

from __future__ import annotations

import math
from functools import partial
from typing import Any, Callable, NamedTuple, Optional

import torch

from . import conjugate_gradient
from .logger import logger
from .utils.tree import norm as tree_norm
from .utils.tree import size, tree_axpy, tree_map, vdot

__all__ = ["OptimizeResults", "minimize", "newton_cg", "static_newton_cg"]


class OptimizeResults(NamedTuple):
    x: Any
    success: Any
    status: Any
    fun: Any
    jac: Any
    hess: Any = None
    hess_inv: Any = None
    nfev: Any = None
    njev: Any = None
    nhev: Any = None
    nit: Any = None


def _prepare_vag_hessp(fun, jac, hessp, fun_and_grad):
    """``(fun, fun_and_grad, hessp)``, deriving the missing ones from ``fun``
    (the Hessian-vector product forward over reverse)."""
    if fun_and_grad is None:
        if fun is not None and jac is not None:
            fun_and_grad = lambda x: (fun(x), jac(x))  # noqa: E731
        elif fun is not None:
            fun_and_grad = value_and_grad(fun)
        else:
            raise ValueError("no function (or value-and-grad) given")
    if hessp is None:
        if fun is None:
            raise NotImplementedError("Newton-CG requires `hessp` (or `fun` to derive it from)")

        def hessp(primals, tangents):
            return torch.func.jvp(torch.func.grad(fun), (primals,), (tangents,))[1]

    return fun, fun_and_grad, hessp


def value_and_grad(fun):
    """``x -> (fun(x), grad fun(x))``."""
    grad_and_value = torch.func.grad_and_value(fun)

    def vg(x):
        g, v = grad_and_value(x)
        return v, g

    return vg


def _cg_tolerances(g, cg_kwargs):
    """The inner CG's residual norm: min(0.5, √|g|) |g|, |g| the 1-norm
    (or the CG's own ``norm_ord``) of the gradient."""
    mag_g = tree_norm(g, ord=cg_kwargs.get("norm_ord", 1))
    return torch.clamp_max(torch.sqrt(mag_g), 0.5) * mag_g


def _steepest_descent(g, hessp, pos):
    """The gradient scaled by ⟨g, g⟩ / ⟨g, H g⟩: the line search's reset."""
    gam = vdot(g, g).real
    curv = vdot(g, hessp(pos, g)).real
    return tree_map(lambda x: (gam / curv) * x, g)


def newton_cg(
    fun=None,
    x0=None,
    *,
    miniter: Optional[int] = None,
    maxiter: Optional[int] = None,
    energy_reduction_factor: float = 0.1,
    old_fval=None,
    absdelta: Optional[float] = None,
    norm_ord=None,
    xtol: float = 1e-5,
    jac: Optional[Callable] = None,
    fun_and_grad: Optional[Callable] = None,
    hessp: Optional[Callable] = None,
    name: Optional[str] = None,
    cg: Callable = conjugate_gradient.cg,
    cg_kwargs: Optional[dict] = None,
    custom_gradnorm: Optional[Callable] = None,
) -> OptimizeResults:
    """Newton-CG with host control flow; status 0 converged, ``maxiter`` at
    the iteration limit, -1 when the line search failed."""
    norm_ord = 1 if norm_ord is None else norm_ord
    miniter = 0 if miniter is None else miniter
    maxiter = 200 if maxiter is None else maxiter
    xtol = xtol * size(x0)
    cg_kwargs = {} if cg_kwargs is None else dict(cg_kwargs)
    gradnorm = partial(tree_norm, ord=norm_ord) if custom_gradnorm is None else custom_gradnorm
    fun, fun_and_grad, hessp = _prepare_vag_hessp(fun, jac, hessp, fun_and_grad)

    pos = x0
    energy, g = fun_and_grad(pos)
    if math.isnan(float(energy)):
        raise ValueError("energy is NaN")
    nfev, njev, nhev = 1, 1, 0
    status = -1
    i = 0
    for i in range(1, maxiter + 1):
        if old_fval is not None and energy_reduction_factor:
            cg_absdelta = energy_reduction_factor * (old_fval - energy)
        else:
            cg_absdelta = None if absdelta is None else absdelta / 100.0
        cg_res = cg(
            partial(hessp, pos),
            g,
            **{
                "absdelta": cg_absdelta,
                "resnorm": _cg_tolerances(g, cg_kwargs),
                "norm_ord": 1,
                "_raise_nonposdef": False,
                "name": None if name is None else name + "CG",
                **cg_kwargs,
            },
        )
        nhev += int(cg_res.nfev)
        if int(cg_res.info) < 0:
            raise ValueError("conjugate gradient failed")

        dd, scale, reset = cg_res.x, 1.0, False
        for ls_it in range(9):
            new_pos = tree_axpy(-scale, dd, pos)
            new_energy, new_g = fun_and_grad(new_pos)
            nfev, njev = nfev + 1, njev + 1
            if new_energy <= energy:
                break
            scale /= 2.0
            if ls_it == 5:
                dd, scale, reset = _steepest_descent(g, hessp, pos), 1.0, True
                nhev += 1
        else:
            logger.warning(f"{name or 'N'}: WARNING: energy would increase; aborting")
            status = -1
            break

        energy_diff = float(energy - new_energy)
        old_fval, energy, pos, g = energy, new_energy, new_pos, new_g
        descent_norm = scale * float(gradnorm(dd))
        if name is not None:
            logger.info(
                f"{name}: it {i} E {float(energy):+.6e} dE {energy_diff:.3e}"
                f" ls {ls_it}{' reset' if reset else ''}"
            )
        if math.isnan(float(energy)):
            raise ValueError("energy is NaN")
        if absdelta is not None and 0.0 <= energy_diff < absdelta and ls_it < 2 and i > miniter:
            status = 0
            break
        if descent_norm <= xtol and i > miniter:
            status = 0
            break
    else:
        status = i
        logger.error(f"{name or 'N'}: iteration limit reached")
    return OptimizeResults(
        x=pos, success=True, status=status, fun=energy, jac=g,
        nit=i, nfev=nfev, njev=njev, nhev=nhev,
    )


def static_newton_cg(
    fun=None,
    x0=None,
    *,
    miniter: Optional[int] = None,
    maxiter: Optional[int] = None,
    energy_reduction_factor: float = 0.1,
    old_fval=math.nan,
    absdelta: Optional[float] = None,
    norm_ord=None,
    xtol: float = 1e-5,
    jac: Optional[Callable] = None,
    fun_and_grad: Optional[Callable] = None,
    hessp: Optional[Callable] = None,
    name: Optional[str] = None,
    cg: Callable = conjugate_gradient.static_cg,
    cg_kwargs: Optional[dict] = None,
    custom_gradnorm: Optional[Callable] = None,
) -> OptimizeResults:
    """Newton-CG with the JAX package's ``lax`` semantics: status 0
    converged, ``maxiter`` at the iteration limit, -1 after a failed line
    search (the position is kept)."""
    norm_ord = 1 if norm_ord is None else norm_ord
    miniter = 0 if miniter is None else miniter
    maxiter = 200 if maxiter is None else maxiter
    xtol = xtol * size(x0)
    cg_kwargs = {} if cg_kwargs is None else dict(cg_kwargs)
    gradnorm = partial(tree_norm, ord=norm_ord) if custom_gradnorm is None else custom_gradnorm
    fun, fun_and_grad, hessp = _prepare_vag_hessp(fun, jac, hessp, fun_and_grad)

    pos = x0
    energy, g = fun_and_grad(pos)
    old = torch.full_like(energy, math.nan if old_fval is None else float(old_fval))
    fallback = -math.inf if absdelta is None else absdelta / 100.0
    status, i = -2, 0
    while status == -2:
        i += 1
        # no earlier energy (NaN): the fallback disables or fixes the forcing term
        cg_absdelta = (
            torch.where(torch.isnan(old), fallback, energy_reduction_factor * (old - energy))
            if energy_reduction_factor
            else fallback
        )
        cg_res = cg(
            partial(hessp, pos),
            g,
            **{
                "absdelta": cg_absdelta,
                "resnorm": _cg_tolerances(g, cg_kwargs),
                "norm_ord": 1,
                "_raise_nonposdef": False,
                **cg_kwargs,
            },
        )
        dd, scale = cg_res.x, 1.0
        for ls_it in range(9):
            if ls_it == 6:
                dd, scale = _steepest_descent(g, hessp, pos), 1.0
            trial = tree_axpy(-scale, dd, pos)
            trial_energy, trial_g = fun_and_grad(trial)
            accepted = bool(trial_energy <= energy)
            if accepted:
                break
            scale_tried, scale = scale, scale / 2.0
        n_tried = ls_it + 1
        accepted_scale = scale if accepted else scale_tried
        descent_norm = accepted_scale * gradnorm(dd)
        if accepted:
            energy_diff = energy - trial_energy
            old, pos, energy, g = energy, trial, trial_energy, trial_g
        else:
            energy_diff = torch.zeros_like(energy)
            old = energy
            status = -1
        if name is not None:
            logger.info(f"{name}: it {i} E {float(energy):+.6e} dE {float(energy_diff):.3e}")
        if status == -2 and i > miniter:
            conv_abs = (
                absdelta is not None
                and 0.0 <= float(energy_diff) < absdelta
                and n_tried <= 2
            )
            if conv_abs or bool(descent_norm <= xtol):
                status = 0
        if status == -2 and i >= maxiter:
            status = i
    return OptimizeResults(
        x=pos, success=status >= 0, status=status, fun=energy, jac=g, nit=i
    )


def minimize(
    fun: Optional[Callable],
    x0,
    *,
    method: str,
    tol: Optional[float] = None,
    options: Optional[dict] = None,
) -> OptimizeResults:
    """SciPy-style dispatcher over the ported minimisers."""
    options = {} if options is None else dict(options)
    m = method.lower().replace("_", "-")
    if tol is not None:
        options.setdefault("xtol", tol)
    if m in ("newton-cg", "newtoncg", "ncg"):
        return newton_cg(fun, x0, **options)
    if m in ("static-newton-cg", "staticnewtoncg"):
        return static_newton_cg(fun, x0, **options)
    if m in ("trust-ncg", "trustncg", "l-bfgs", "lbfgs", "optax"):
        raise NotImplementedError(f"method {method!r} is not ported (ROADMAP.md, section A)")
    raise ValueError(f"unknown method {method!r}")
