"""Frozen work counts and the card's peaks, from which the rooflines and
the whole step's share of the chip (``step_mfu``) are read.

Every count is a pure function of a configuration's shapes and a traffic
mix's fixed settings, never read from the program, so that a later kernel
that does the same work with fewer launches or bytes cannot make them
stale.  They count what the mathematics needs: each input read once, each
output written once, whatever the program reads again.

Notation: ``N = n²`` pixels, ``C = (n/2 + 1)²`` pixels of the |k| core that
the knot form evaluates, ``K`` knots, 4 bytes a float32.

- One real 2-D Hartley transform of ``N`` pixels: ``2.5 N log₂ N`` f32
  operations (half of a complex FFT's ``5 N log₂ N``), ``8 N`` bytes (the
  grid read, the result written).
- One metric apply ``(Jᵀ diag(λ) J + 𝟙) t`` at a fixed position: two
  transforms (J's and Jᵀ's); the spectrum's tangent and its pull-back
  through the knot map, ``3 (K − 1) C`` operations a direction (a
  subtraction, a clamp and a fused multiply-add a knot and pixel), or for
  the exact form the table's gather and scatter, ``2 N``; ``10 N`` for the
  elementwise products (amplitude, λ, the identity's add); bytes: the
  tangent read, the result written, λ read (``12 N``).
- One CG iteration: one apply and the solver's vectors: the direction and
  the product read for the curvature, the position, residual and
  direction updated (read and written), ``28 N`` bytes and ``10 N``
  operations.
- One MGVI iteration of ``P`` pairs, draw CG ``c_d``, KL CG ``c_k``: the
  draws ``P (c_d + 1)`` CG iterations (the start's residual is one apply)
  and ``P`` pull-backs of ``√λ d̃`` (half an apply each) with their white
  noise (``(2 N) 4`` bytes written a sample); the KL ``2P`` gradients
  (half an apply and a forward each, counted as one apply), ``c_k`` CG
  iterations of ``2P`` applies and one set of vectors each, and one
  line-search trial of ``2P`` energies (a forward each, counted as half an
  apply)."""

from __future__ import annotations

import math

__all__ = [
    "F32_OPS_PER_S",
    "HBM_BYTES_PER_S",
    "apply_work",
    "bound_s",
    "cg_iteration_work",
    "hartley_work",
    "pwl_apply_bytes",
    "vi_iteration_work",
]

HBM_BYTES_PER_S = 3.35e12  # NVIDIA H100 SXM, 700 W: 3.35 TB/s
F32_OPS_PER_S = 67e12  # NVIDIA H100 SXM, 700 W: 67 TFLOP/s float32 outside the tensor cores


def bound_s(n_bytes, ops):
    """The least time the card could take: the larger of bytes over the
    memory rate and float32 operations over the float32 rate."""
    return max(n_bytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S)


def _sizes(model):
    n = int(model["grid_side"])
    return n * n, (n // 2 + 1) ** 2


def hartley_work(model):
    """``(bytes, operations)`` of one real 2-D Hartley transform."""
    N, _ = _sizes(model)
    return 8.0 * N, 2.5 * N * math.log2(N)


def pwl_apply_bytes(model):
    """Bytes the knot map needs in one apply: the tangent's spectrum on the
    core (log |k| read, the result written) and its pull-back (log |k| and
    the cotangent read)."""
    _, C = _sizes(model)
    return 4.0 * 4 * C


def apply_work(model):
    """``(bytes, operations)`` of one metric apply at a fixed position."""
    N, C = _sizes(model)
    _, hops = hartley_work(model)
    knots = model.get("n_mode_knots")
    spectrum = 2 * 3.0 * (knots - 1) * C if knots else 2.0 * N
    return 12.0 * N, 2 * hops + spectrum + 10.0 * N


def _vector_work(model):
    N, _ = _sizes(model)
    return 28.0 * N, 10.0 * N


def cg_iteration_work(model):
    """``(bytes, operations)`` of one CG iteration: an apply and the
    solver's vector work."""
    b, ops = apply_work(model)
    vb, vops = _vector_work(model)
    return b + vb, ops + vops


def vi_iteration_work(model, traffic):
    """``(bytes, operations)`` of one MGVI iteration of the mix ``traffic``."""
    N, _ = _sizes(model)
    p, c_d, c_k = int(traffic["n_samples"]), int(traffic["draw_cg"]), int(traffic["kl_cg"])
    b_ap, ops_ap = apply_work(model)
    vb, vops = _vector_work(model)
    applies = p * (c_d + 1) + c_k * 2 * p + 0.5 * p + 2 * p + 0.5 * 2 * p
    vectors = p * (c_d + 1) + c_k
    return applies * b_ap + vectors * vb + p * 8.0 * N, applies * ops_ap + vectors * vops
