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

:func:`trust_ncg` is the trust-region Newton-CG (Nocedal & Wright,
algorithm 4.1) over :func:`~.conjugate_gradient.cg_steihaug`, with the JAX
package's status codes (0 converged, 1 the iteration limit, 2 a bad
gradient or a model that predicts no decrease); the host reads the status
once an iteration.

:func:`optim_wrapper` is the counterpart of the JAX package's
``optax_wrapper``: any ``torch.optim`` optimizer (a factory of the
position's leaves) stepped in a host loop under the reference's stopping
rule.  Adam takes one step an iteration; L-BFGS (``minimize(method=
"l-bfgs")``) one iteration a step, its line search calling the closure
again as optax's threads values through its state.
"""

from __future__ import annotations

import math
from functools import partial
from typing import Any, Callable, NamedTuple, Optional

import torch
from torch.utils._pytree import tree_flatten, tree_leaves, tree_unflatten

from . import conjugate_gradient, tracing
from .logger import logger
from .utils.misc import hvp
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

__all__ = [
    "OptimizeResults",
    "minimize",
    "newton_cg",
    "optim_wrapper",
    "static_newton_cg",
    "trust_ncg",
]


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
            return hvp(fun, (primals,), (tangents,))

    return fun, fun_and_grad, hessp


def value_and_grad(fun):
    """``x -> (fun(x), grad fun(x))``."""
    grad_and_value = torch.func.grad_and_value(fun)

    def vg(x):
        g, v = grad_and_value(x)
        return v, g

    return vg


def _cg_tolerances(g, cg_kwargs, nrm=tree_norm):
    """The inner CG's residual norm: min(0.5, √|g|) |g|, |g| the 1-norm
    (or the CG's own ``norm_ord``) of the gradient."""
    mag_g = nrm(g, ord=cg_kwargs.get("norm_ord", 1))
    return torch.clamp_max(torch.sqrt(mag_g), 0.5) * mag_g


def _steepest_descent(g, hessp, pos, dot=vdot):
    """The gradient scaled by ⟨g, g⟩ / ⟨g, H g⟩: the line search's reset."""
    gam = dot(g, g).real
    curv = dot(g, hessp(pos, g)).real
    return tree_axpy(gam / curv, g, zeros_like(g))


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
    batched: bool = False,
) -> OptimizeResults:
    """Newton-CG with the JAX package's ``lax`` semantics: status 0
    converged, ``maxiter`` at the iteration limit, -1 after a failed line
    search (the position is kept); ``status``, ``fun`` and ``nit`` are 0-d
    tensors.

    ``batched``: ``x0`` is a forest of B independent problems;
    ``fun_and_grad`` returns the B energies and the forest of gradients,
    ``hessp`` and ``custom_gradnorm`` map forests sample by sample, and
    ``cg`` must take ``batched=True`` (:func:`~.conjugate_gradient.static_cg`
    does).  Every sample has its own line search (at most 9 trials, the
    steepest-descent reset at trial 6), its own status and iteration count;
    a sample that has stopped is frozen by a mask while the others go on,
    as under ``jax.vmap`` of the JAX package's loop.  As lanes do there, a
    stopped sample still costs its CG and its line-search trials while
    others run; the search ends once every running sample has accepted a
    trial.  The host reads one flag a line-search trial and one a Newton
    step (all accepted, all stopped), each through
    :func:`~.tracing.host_read`; each trial is the span ``newton.trial``."""
    dot, nrm = (sample_vdot, sample_norm) if batched else (vdot, tree_norm)
    lead = tuple(tree_leaves(x0)[0].shape[:1]) if batched else ()
    norm_ord = 1 if norm_ord is None else norm_ord
    miniter = 0 if miniter is None else miniter
    maxiter = 200 if maxiter is None else maxiter
    xtol = xtol * (size(x0) // (lead[0] if lead else 1))
    cg_kwargs = {} if cg_kwargs is None else dict(cg_kwargs)
    if batched:
        cg_kwargs["batched"] = True
    gradnorm = partial(nrm, ord=norm_ord) if custom_gradnorm is None else custom_gradnorm
    fun, fun_and_grad, hessp = _prepare_vag_hessp(fun, jac, hessp, fun_and_grad)

    pos = x0
    energy, g = fun_and_grad(pos)
    old = torch.full_like(energy, math.nan if old_fval is None else float(old_fval))
    fallback = -math.inf if absdelta is None else absdelta / 100.0
    status = torch.full(lead, -2, dtype=torch.int32, device=energy.device)  # -2: go on
    nit = torch.zeros(lead, dtype=torch.int32, device=energy.device)
    i = 0
    while tracing.host_read((status == -2).any()):
        i += 1
        running = status == -2
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
                "resnorm": _cg_tolerances(g, cg_kwargs, nrm),
                "norm_ord": 1,
                "_raise_nonposdef": False,
                **cg_kwargs,
            },
        )
        # the line search: successive halving along -dd, each sample its own
        dd = cg_res.x
        scale = torch.ones_like(energy)
        accepted = torch.zeros(lead, dtype=torch.bool, device=energy.device)
        new_pos, new_energy, new_g = pos, energy, g
        n_tried = torch.zeros(lead, dtype=torch.int32, device=energy.device)
        for ls_it in range(9):
            if ls_it == 6:
                dd = where(accepted, dd, _steepest_descent(g, hessp, pos, dot))
                scale = torch.where(accepted, scale, 1.0)
            trial = tree_axpy(-scale, dd, pos)
            with tracing.span("newton.trial"):
                trial_energy, trial_g = fun_and_grad(trial)
            took = ~accepted & (trial_energy <= energy)
            new_pos, new_energy, new_g = where(
                took, (trial, trial_energy, trial_g), (new_pos, new_energy, new_g)
            )
            n_tried = torch.where(accepted, n_tried, ls_it + 1).to(torch.int32)
            accepted = accepted | took
            if tracing.host_read((accepted | ~running).all()):
                break
            # a failed sample keeps the last scale it tried
            scale = torch.where(accepted | (ls_it == 8), scale, scale / 2.0)
        descent_norm = scale * gradnorm(dd)
        energy_diff = torch.where(accepted, energy - new_energy, 0.0)
        pos, g, old, energy = where(
            running, (new_pos, new_g, energy, new_energy), (pos, g, old, energy)
        )
        step_status = torch.where(accepted, status, -1)
        if name is not None:
            logger.info(
                f"{name}: it {i} E {energy.tolist()} dE {energy_diff.tolist()}"
            )
        if i > miniter:
            conv = descent_norm <= xtol
            if absdelta is not None:
                conv = conv | ((energy_diff >= 0.0) & (energy_diff < absdelta) & (n_tried <= 2))
            step_status = torch.where(conv & (step_status == -2), 0, step_status)
        if i >= maxiter:
            step_status = torch.where(step_status == -2, i, step_status)
        status = torch.where(running, step_status, status).to(torch.int32)
        nit = torch.where(running, i, nit).to(torch.int32)
    return OptimizeResults(
        x=pos, success=status >= 0, status=status, fun=energy, jac=g, nit=nit
    )


def trust_ncg(
    fun=None,
    x0=None,
    *,
    maxiter: Optional[int] = None,
    energy_reduction_factor: float = 0.1,
    old_fval=math.nan,
    absdelta: Optional[float] = None,
    gtol: float = 1e-4,
    max_trust_radius: float = 1000.0,
    initial_trust_radius: float = 1.0,
    eta: float = 0.15,
    jac: Optional[Callable] = None,
    fun_and_grad: Optional[Callable] = None,
    hessp: Optional[Callable] = None,
    subproblem: Callable = conjugate_gradient.cg_steihaug,
    subproblem_kwargs: Optional[dict] = None,
    name: Optional[str] = None,
) -> OptimizeResults:
    """Trust-region Newton-CG: each iteration solves the subproblem in the
    trust radius (``subproblem``, Steihaug's CG, with the forcing term and
    residual norm of :func:`static_newton_cg`), takes the step when the
    actual decrease is more than ``eta`` of the predicted one, and shrinks
    the radius below a quarter of it or doubles it (up to
    ``max_trust_radius``) above three quarters on the boundary.  Converged
    (status 0) when the energy stops changing, the gradient's norm falls
    below ``gtol`` or an accepted decrease below ``absdelta``."""
    maxiter = 200 if maxiter is None else maxiter
    if not 0 <= eta < 0.25:
        raise ValueError("invalid acceptance stringency `eta`")
    if gtol < 0.0 or max_trust_radius <= 0.0 or initial_trust_radius <= 0.0:
        raise ValueError("tolerances and radii must be positive")
    if initial_trust_radius >= max_trust_radius:
        raise ValueError("the initial trust radius must be below the maximum")
    subproblem_kwargs = {} if subproblem_kwargs is None else dict(subproblem_kwargs)
    fun, fun_and_grad, hessp = _prepare_vag_hessp(fun, jac, hessp, fun_and_grad)
    eps = 6.0 * torch.finfo(tree_leaves(x0)[0].dtype).eps
    grad_norm = partial(tree_norm, ord=subproblem_kwargs.get("norm_ord", 1))
    fallback = -math.inf if absdelta is None else absdelta / 100.0

    pos = x0
    energy, g = fun_and_grad(pos)
    g_mag = grad_norm(g)
    old = torch.full_like(energy, math.nan if old_fval is None else float(old_fval))
    radius = torch.full_like(energy, initial_trust_radius)
    status = torch.where(torch.isfinite(g_mag), -2 if maxiter > 0 else 1, 2).to(torch.int32)
    nit = nhev = torch.zeros_like(status)
    i = 0
    while bool(status == -2):
        i += 1
        cg_absdelta = (
            torch.where(torch.isnan(old), fallback, energy_reduction_factor * (old - energy))
            if energy_reduction_factor
            else fallback
        )
        sub = subproblem(
            partial(hessp, pos),
            g,
            **{
                "trust_radius": radius,
                "cur_val": energy,
                "absdelta": cg_absdelta,
                "resnorm": torch.clamp_max(torch.sqrt(g_mag), 0.5) * g_mag,
                "norm_ord": 1,
                **subproblem_kwargs,
            },
        )
        trial = tree_map(torch.add, pos, sub.step)
        trial_energy, trial_g = fun_and_grad(trial)
        actual_red = energy - trial_energy
        pred_red = energy - sub.pred_f
        rho = actual_red / pred_red
        new_radius = torch.where(rho < 0.25, 0.25 * radius, radius)
        new_radius = torch.where(
            (rho > 0.75) & sub.hits_boundary,
            torch.clamp_max(2.0 * radius, max_trust_radius),
            new_radius,
        )
        accept = rho > eta
        old = energy
        pos, energy, g, g_mag = where(
            accept, (trial, trial_energy, trial_g, grad_norm(trial_g)), (pos, energy, g, g_mag)
        )
        energy_eps = eps * energy.abs()
        converged = ((actual_red <= energy_eps) & (actual_red > -energy_eps)) | (g_mag < gtol)
        if absdelta is not None:
            converged = converged | (accept & (actual_red > 0.0) & (actual_red < absdelta))
        status = torch.where(converged & (status == -2), 0, status)
        status = torch.where((i >= maxiter) & (status == -2), 1, status)
        status = torch.where(pred_red <= 0, 2, status).to(torch.int32)
        radius = new_radius
        nit = torch.full_like(nit, i)
        nhev = nhev + sub.nhev
        if name is not None:
            logger.info(f"{name}: it {i} E {float(energy):+.6e} radius {float(radius):.3e}")
    return OptimizeResults(
        x=pos, success=status == 0, status=status, fun=energy, jac=g, nit=nit, nhev=nhev
    )


def optim_wrapper(
    fun=None,
    x0=None,
    *,
    optimizer=None,
    maxiter: Optional[int] = None,
    miniter: Optional[int] = None,
    jac: Optional[Callable] = None,
    fun_and_grad: Optional[Callable] = None,
    hessp: Optional[Callable] = None,
    name: Optional[str] = None,
    xtol: float = 1e-5,
) -> OptimizeResults:
    """Minimise with a ``torch.optim`` optimizer: ``optimizer`` maps a list
    of leaf tensors (copies of ``x0``'s leaves) to an optimizer
    (``lambda ps: torch.optim.Adam(ps, lr=0.2)``, say).  Each iteration is
    one ``optimizer.step(closure)``; the closure sets the leaves' ``.grad``
    from ``fun`` by autograd (or from ``fun_and_grad``/``jac``) and returns
    the value, and L-BFGS calls it again in its line search.  The loop
    stops once an iteration moves the position by at most ``xtol`` times
    its size in the 2-norm (after ``miniter`` iterations) or after
    ``maxiter``, the stopping rule of the JAX package's ``optax_wrapper``;
    ``hessp`` is not used."""
    del hessp
    if optimizer is None:
        raise ValueError("`optimizer` (a factory of a torch.optim optimizer) is required")
    miniter = 0 if miniter is None else miniter
    maxiter = 200 if maxiter is None else maxiter
    xtol = xtol * size(x0)
    if fun_and_grad is None and fun is not None and jac is not None:
        fun_and_grad = lambda x: (fun(x), jac(x))  # noqa: E731
    if fun_and_grad is None and fun is None:
        raise ValueError("no function (or value-and-grad) given")
    leaves, spec = tree_flatten(x0)
    params = [x.detach().clone().requires_grad_(True) for x in leaves]
    opt = optimizer(params)

    def closure():
        opt.zero_grad()
        if fun_and_grad is None:
            value = fun(tree_unflatten(params, spec))
            value.backward()
            return value.detach()
        value, grad = fun_and_grad(tree_unflatten([p.detach() for p in params], spec))
        for p, g in zip(params, tree_leaves(grad)):
            p.grad = g.detach().clone()
        return value

    nit, descent = 0, math.inf
    while (descent > xtol or nit < miniter) and nit < maxiter:
        before = [p.detach().clone() for p in params]
        value = opt.step(closure)
        descent = math.sqrt(sum(float(((p.detach() - b) ** 2).sum()) for p, b in zip(params, before)))
        nit += 1
        if name is not None:
            logger.info(f"{name}: it {nit} E {float(value):+.6e} |Δx| {descent:.3e}")
    x = tree_unflatten([p.detach() for p in params], spec)
    value, grad = fun_and_grad(x) if fun_and_grad is not None else value_and_grad(fun)(x)
    return OptimizeResults(x=x, success=True, status=0 if nit < maxiter else 1, fun=value,
                           jac=grad, nit=nit)


def _lbfgs(params):
    """torch's L-BFGS, one iteration a step, with a strong-Wolfe line search
    of up to 24 evaluations (its budget is ``max_eval`` less the step's first
    evaluation; the default, 5/4 of ``max_iter``, leaves none)."""
    return torch.optim.LBFGS(params, lr=1.0, max_iter=1, max_eval=25,
                             line_search_fn="strong_wolfe")


def minimize(
    fun: Optional[Callable],
    x0,
    *,
    method: str,
    tol: Optional[float] = None,
    options: Optional[dict] = None,
) -> OptimizeResults:
    """SciPy-style dispatcher over the ported minimisers; ``"optim"`` runs
    :func:`optim_wrapper` with ``options["optimizer"]`` (the JAX package's
    ``"optax"``), ``"l-bfgs"`` the same with torch's L-BFGS."""
    options = {} if options is None else dict(options)
    m = method.lower().replace("_", "-")
    if tol is not None:
        options.setdefault("gtol" if m in ("trust-ncg", "trustncg") else "xtol", tol)
    if m in ("newton-cg", "newtoncg", "ncg"):
        return newton_cg(fun, x0, **options)
    if m in ("static-newton-cg", "staticnewtoncg"):
        return static_newton_cg(fun, x0, **options)
    if m in ("trust-ncg", "trustncg"):
        return trust_ncg(fun, x0, **options)
    if m in ("l-bfgs", "lbfgs"):
        options.setdefault("optimizer", _lbfgs)
        return optim_wrapper(fun, x0, **options)
    if m == "optim":
        return optim_wrapper(fun, x0, **options)
    raise ValueError(f"unknown method {method!r}")
