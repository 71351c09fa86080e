"""Faults planted under the program's timed path, to read what the check
makes of them: the CPU tests plant each at a tiny size, and
``calibrate.py --fault`` at a cell's own size on the card.

Each is a context manager that swaps a public function of the port for a
broken one while the step is built and run:

- ``"state unchanged"``: every CG solve (a ``"cg"`` mix) or Newton step
  (a ``"vi"`` mix) returns its start;
- ``"answer altered"``: every CG answer scaled by 1.01;
- ``"truncated"``: every CG solve stops after a quarter of its iterations;
- ``"steepest descent"``: CG without its ``β``, each direction the residual;
- ``"pull-back dropped"``: the knot map's pull-back returns zeros;
- ``"half of the batch"``: the KL's mean over the first half of the samples.
"""

from __future__ import annotations

import contextlib

import torch

__all__ = ["FAULTS", "planted"]


def _signed(fn):
    """``fn`` under the signature the samplers ask of a solver."""

    def solver(mat, j, x0=None, *, batched=False, **kw):
        return fn(mat, j, x0=x0, batched=batched, **kw)

    return solver


def _steepest(mat, j, x0=None, *, batched=False, maxiter, **_):
    """``maxiter`` steps of CG with ``β = 0`` in the program's precision."""
    from nifty_tpu_torch.conjugate_gradient import CGResults

    def dot(a, b):
        if not batched:
            return sum(torch.sum(a[k] * b[k]) for k in a)
        return sum((a[k] * b[k]).reshape(a[k].shape[0], -1).sum(dim=1) for k in a)

    def scaled(alpha, v):
        return {k: (alpha.view(-1, *[1] * (t.dim() - 1)) if batched else alpha) * t
                for k, t in v.items()}

    if x0 is None:
        x = {k: torch.zeros_like(v) for k, v in j.items()}
        r = {k: -v for k, v in j.items()}
    else:
        q = mat(x0)
        x, r = dict(x0), {k: q[k] - j[k] for k in j}
    for _ in range(maxiter):
        q = mat(r)
        alpha = dot(r, r) / dot(r, q)
        dx, dr = scaled(alpha, r), scaled(alpha, q)
        x, r = {k: x[k] - dx[k] for k in x}, {k: r[k] - dr[k] for k in r}
    leaf = next(iter(j.values()))
    nit = torch.full(leaf.shape[:1] if batched else (), maxiter, dtype=torch.int32, device=leaf.device)
    return CGResults(x=x, nit=nit, nfev=nit, info=torch.zeros_like(nit), success=nit >= 0)


def _half_mean(forest):
    from torch.utils._pytree import tree_map

    return tree_map(lambda v: v[: max(1, v.shape[0] // 2)].mean(dim=0), forest)


@contextlib.contextmanager
def planted(fault, kind):
    """The port with ``fault`` planted, for a mix of ``kind``."""
    import nifty_tpu_torch as nt
    from nifty_tpu_torch.ops import pwl

    cg, newton, transpose = nt.static_cg, nt.static_newton_cg, pwl.pwl_transpose
    kl_reduce = nt.OptimizeVI.__init__.__kwdefaults__["kl_reduce"]
    if fault == "state unchanged" and kind == "cg":
        nt.static_cg = _signed(lambda mat, j, x0=None, **kw: cg(mat, j, x0=x0, **kw)._replace(
            x={k: torch.zeros_like(v) for k, v in j.items()} if x0 is None else x0))
    elif fault == "state unchanged":
        nt.static_newton_cg = lambda fun=None, x0=None, **kw: newton(fun, x0=x0, **kw)._replace(x=x0)
    elif fault == "answer altered":
        nt.static_cg = _signed(lambda mat, j, x0=None, **kw: (lambda r: r._replace(
            x={k: 1.01 * v for k, v in r.x.items()}))(cg(mat, j, x0=x0, **kw)))
    elif fault == "truncated":
        def short(mat, j, x0=None, *, maxiter, miniter=None, **kw):
            n = max(1, maxiter // 4)
            return cg(mat, j, x0=x0, maxiter=n, miniter=min(n, miniter or n), **kw)

        nt.static_cg = _signed(short)
    elif fault == "steepest descent":
        nt.static_cg = _signed(_steepest)
    elif fault == "pull-back dropped":
        pwl.pwl_transpose = lambda *args: torch.zeros_like(transpose(*args))
    elif fault == "half of the batch":
        nt.OptimizeVI.__init__.__kwdefaults__["kl_reduce"] = _half_mean
    else:
        raise ValueError(f"unknown fault {fault!r}; one of {FAULTS}")
    try:
        yield
    finally:
        nt.static_cg, nt.static_newton_cg, pwl.pwl_transpose = cg, newton, transpose
        nt.OptimizeVI.__init__.__kwdefaults__["kl_reduce"] = kl_reduce


FAULTS = ("state unchanged", "answer altered", "truncated", "steepest descent",
          "pull-back dropped", "half of the batch")
