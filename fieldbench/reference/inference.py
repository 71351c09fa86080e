"""Poisson inference over the reference field: the Fisher metric, plain
conjugate gradients, the MGVI draw and the KL's Newton step.

With ``λ = exp(s(p))`` and counts ``d``: the energy ``Σ λ − Σ d s + ½‖p‖²``,
its gradient ``Jᵀ(λ − d) + p``, the metric ``Jᵀ diag(λ) J + 𝟙`` (the
Poisson Fisher metric ``1/λ`` pulled back through ``exp``), and the
likelihood's square root ``Jᵀ diag(√λ)``.  ``J`` is the field's Jacobian
(:meth:`.field.Field.linearization`)."""

from __future__ import annotations

import torch

from . import philox
from .field import Field

__all__ = ["Posterior", "axpy", "cg", "vdot"]


def vdot(a, b):
    return sum(torch.sum(a[k] * b[k]) for k in a)


def axpy(alpha, x, y):
    """``alpha x + y``, key by key."""
    return {k: alpha * x[k] + y[k] for k in x}


def cg(mat, j, x0, iterations, store=lambda t: t):
    """Plain conjugate gradients for ``mat(x) = j`` from ``x0`` (zeros when
    None), exactly ``iterations`` steps; ``store`` rounds each new vector."""
    if x0 is None:
        x = {k: torch.zeros_like(v) for k, v in j.items()}
        r = {k: -v for k, v in j.items()}
    else:
        x = x0
        q = mat(x)
        r = {k: store(q[k] - j[k]) for k in j}
    d = r
    gamma = vdot(r, r)
    for _ in range(iterations):
        q = mat(d)
        alpha = gamma / vdot(d, q)
        x = {k: store(v) for k, v in axpy(-alpha, d, x).items()}
        r = {k: store(v) for k, v in axpy(-alpha, q, r).items()}
        new_gamma = vdot(r, r)
        d = {k: store(v) for k, v in axpy(new_gamma / gamma, d, r).items()}
        gamma = new_gamma
    return x


class Posterior:
    """The Poisson posterior of ``field`` (a :class:`~.field.Field`) with
    counts ``data``."""

    def __init__(self, field: Field, data):
        self.field = field
        self.prec = field.prec
        self.data = data.to(field.prec.dtype)
        self.solve = lambda mat, j, x0, iterations: cg(mat, j, x0, iterations, self.prec.store)

    def cast(self, tree):
        return {k: v.to(self.prec.dtype) for k, v in tree.items()}

    # -- at one position ------------------------------------------------------

    def metric_at(self, p):
        """``t ↦ (Jᵀ diag(λ) J + 𝟙) t`` at ``p``."""
        s, jvp, vjp = self.field.linearization(p)
        lam = self.prec.store(torch.exp(s))

        def mat(t):
            m = vjp(self.prec.store(lam * jvp(t)))
            return {k: self.prec.store(m[k] + t[k]) for k in t}

        return mat

    def energy_and_grad(self, p):
        s, _, vjp = self.field.linearization(p)
        lam = self.prec.store(torch.exp(s))
        e = torch.sum(lam) - torch.sum(self.data * s) + 0.5 * vdot(p, p)
        g = vjp(self.prec.store(lam - self.data))
        return e, {k: g[k] + p[k] for k in p}

    def energy(self, p):
        s = self.field.forward(p)
        return torch.sum(torch.exp(s)) - torch.sum(self.data * s) + 0.5 * vdot(p, p)

    # -- the MGVI draw ------------------------------------------------------------

    def white_noise(self, key, p):
        """The draws of one residual from ``key``: the data-space normals
        (leaf 0), then one leaf for each key of ``p``, in ``p``'s order."""
        dev, dt = self.data.device, self.prec.dtype
        data = philox.normal(key, 0, tuple(self.data.shape), dt, dev)
        prior = {k: philox.normal(key, i + 1, tuple(v.shape), dt, dev) for i, (k, v) in enumerate(p.items())}
        return data, prior

    def draw(self, p, key, iterations):
        """The MGVI residual of ``key`` at ``p``: ``(M + 𝟙)⁻¹ (Jᵀ √λ d̃ + ξ̃)``
        by ``iterations`` CG steps from ``ξ̃``."""
        white_d, white_p = self.white_noise(key, p)
        s, _, vjp = self.field.linearization(p)
        lam = self.prec.store(torch.exp(s))
        lsm = vjp(self.prec.store(torch.sqrt(lam) * white_d))
        t = {k: self.prec.store(lsm[k] + white_p[k]) for k in p}
        return self.solve(self.metric_at(p), t, white_p, iterations)

    # -- the KL ---------------------------------------------------------------------

    def kl_energy_and_grad(self, x, residuals):
        es, gs = zip(*(self.energy_and_grad(axpy(1.0, x, r)) for r in residuals))
        n = len(residuals)
        return sum(es) / n, {k: sum(g[k] for g in gs) / n for k in x}

    def kl_metric(self, x, residuals):
        mats = [self.metric_at(axpy(1.0, x, r)) for r in residuals]
        n = len(mats)

        def mat(t):
            ms = [m(t) for m in mats]
            return {k: sum(m[k] for m in ms) / n for k in t}

        return mat

    def newton_step(self, x, residuals, iterations):
        """One Newton-CG step of the sample-averaged KL from ``x``: the CG
        solve of ``iterations`` steps from 0, then halving along it until
        the energy does not rise (at most 6 trials).  Returns ``(new x,
        trials)``; ``x`` itself and 0 when no trial was taken."""
        e0, g = self.kl_energy_and_grad(x, residuals)
        step = self.solve(self.kl_metric(x, residuals), g, None, iterations)
        scale = 1.0
        for trial in range(1, 7):
            cand = axpy(-scale, step, x)
            e = sum(self.energy(axpy(1.0, cand, r)) for r in residuals) / len(residuals)
            if e <= e0:
                return cand, trial
            scale /= 2.0
        return x, 0

    def mgvi_iteration(self, x, keys, draw_iterations, kl_iterations):
        """One MGVI iteration at ``x``: one mirrored pair of residuals a key,
        then the Newton step.  Returns ``(residuals, new x, line-search
        trials)``, the residuals in the order ``r₁, −r₁, r₂, −r₂, …``."""
        residuals = []
        for key in keys:
            r = self.draw(x, key, draw_iterations)
            residuals += [r, {k: -v for k, v in r.items()}]
        new_x, trials = self.newton_step(x, residuals, kl_iterations)
        return residuals, new_x, trials

