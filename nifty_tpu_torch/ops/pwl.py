"""The relu-feature map of the 64-knot correlated field (counterpart of
``_pwl_features_p`` in ``nifty_tpu/models/correlated_field.py``).

``pwl_features(x, knots, coef) = Σ_k coef_k · relu(x − knots_k)`` over the
first ``K − 1`` knots: a piecewise-linear curve in the relative log mode
length ``x``, evaluated per pixel of the |k| core.  It is linear in
``coef``; ``x`` and ``knots`` are constants of the grid, so the pull-back
goes to ``coef`` alone: ``g_k = Σ_p cot_p · relu(x_p − knots_k)``.

Neither direction may hold the ``(pixels, K)`` feature tensor: at 10240²
the core has 26.2M pixels and that tensor would take 6.7 GB in f32.  Both
run in chunks of :data:`KNOT_CHUNK` knots, so the largest temporary is
``KNOT_CHUNK`` times the core.  The JAX package leaves this map to XLA
outside any Pallas kernel; here it is plain PyTorch (a broadcast
subtraction, a relu and a matrix-vector product per chunk) on every
device.
"""

from __future__ import annotations

import torch

from .. import tracing

__all__ = ["KNOT_CHUNK", "PwlFeatures", "pwl_features", "pwl_transpose"]

KNOT_CHUNK = 4  # knots per chunk: the largest temporary is 4 times the core grid


def _features(x, t):
    """``relu(x[..., None] - t)``: one chunk of the feature tensor."""
    return torch.clamp_min_(x.unsqueeze(-1) - t, 0.0)


def pwl_features(x, knots, coef):
    """``Σ_k coef_k · relu(x − knots_k)`` over ``k < K − 1``, in knot chunks."""
    tracing.count("pwl_passes")
    with tracing.span("pwl.features"):
        t = knots[:-1]
        out = None
        for s in range(0, t.shape[0], KNOT_CHUNK):
            part = _features(x, t[s : s + KNOT_CHUNK]) @ coef[s : s + KNOT_CHUNK]
            out = part if out is None else out + part
        return out


def pwl_transpose(x, knots, cot):
    """Pull-back of :func:`pwl_features` to ``coef``:
    ``g_k = Σ_p cot_p · relu(x_p − knots_k)``, in knot chunks."""
    tracing.count("pwl_passes")
    with tracing.span("pwl.transpose"):
        t = knots[:-1]
        c = cot.reshape(-1)
        parts = [
            c @ _features(x, t[s : s + KNOT_CHUNK]).reshape(-1, min(KNOT_CHUNK, t.shape[0] - s))
            for s in range(0, t.shape[0], KNOT_CHUNK)
        ]
        return torch.cat(parts)


class PwlFeatures(torch.autograd.Function):
    """:func:`pwl_features` as a differentiable map of ``coef``: its backward
    is :func:`pwl_transpose` (``None`` for ``x`` and ``knots``), its jvp the
    map itself applied to the tangent of ``coef``.  ``x`` and ``knots`` are
    treated as constants: no derivative flows to them.  All three are plain
    PyTorch, so ``torch.func.vmap`` batches them itself: under a batch of
    ``coef`` (``B`` samples) each chunk product becomes ``(pixels, 4) @ (4,
    B)``."""

    generate_vmap_rule = True

    @staticmethod
    def forward(x, knots, coef):
        return pwl_features(x, knots, coef)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.x, ctx.knots = inputs[0], inputs[1]

    @staticmethod
    def backward(ctx, cot):
        return None, None, pwl_transpose(ctx.x, ctx.knots, cot)

    @staticmethod
    def jvp(ctx, x_t, knots_t, coef_t):
        # x and knots are constants of the grid: torch.func.jvp hands them
        # zero tangents, which are dropped.  Through apply, as the kernel
        # Functions do: the coef tangent comes wrapped
        return PwlFeatures.apply(ctx.x, ctx.knots, coef_t)
