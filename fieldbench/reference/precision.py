"""The precision the reference computes in.

``Precision("float64")`` is the reference.  The controls are the reference
computed one step below the precision a configuration states:

- ``"tf32"``: float32, with the knot map's matrix products taking their
  operands rounded to TF32 (10 mantissa bits, round to nearest even), as
  the card's tensor cores do with ``allow_tf32``;
- ``"bfloat16"``: float32 arithmetic whose every stored array (the
  amplitude, the field, each transform's output, the rate, the tangents
  and the CG's vectors) is rounded to bfloat16, as half-precision storage
  would."""

from __future__ import annotations

import torch

__all__ = ["Precision", "round_bf16", "round_tf32"]


def round_tf32(x):
    """``x`` (float32) rounded to TF32's 10 mantissa bits, nearest even."""
    i = x.contiguous().view(torch.int32)
    i = (i + 0x0FFF + ((i >> 13) & 1)) & ~0x1FFF
    return i.view(torch.float32)


def round_bf16(x):
    """``x`` (float32) rounded to bfloat16, kept in float32."""
    return x.to(torch.bfloat16).to(x.dtype)


class _Rounded(torch.autograd.Function):
    """``fn(x)`` whose tangents and cotangents are rounded by ``fn`` too."""

    generate_vmap_rule = True

    @staticmethod
    def forward(x, fn):
        return fn(x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.fn = inputs[1]

    @staticmethod
    def backward(ctx, g):
        return ctx.fn(g), None

    @staticmethod
    def jvp(ctx, t, _):
        return ctx.fn(t)


class Precision:
    """``name``: ``"float64"`` (the reference), ``"float32"``, ``"tf32"`` or
    ``"bfloat16"`` (the controls)."""

    NAMES = ("float64", "float32", "tf32", "bfloat16")

    def __init__(self, name: str = "float64"):
        if name not in self.NAMES:
            raise ValueError(f"unknown precision {name!r}; one of {self.NAMES}")
        self.name = name
        self.dtype = torch.float64 if name == "float64" else torch.float32
        self.tf32 = name == "tf32"
        self.bf16 = name == "bfloat16"

    def store(self, x):
        """``x`` as an array is stored: rounded to bfloat16 under that
        control (its derivatives too), unchanged otherwise."""
        if not self.bf16:
            return x
        return _Rounded.apply(x, round_bf16)

    def matmul_operand(self, x):
        """``x`` as a matrix product's operand: TF32 under that control."""
        if not self.tf32:
            return x
        return _Rounded.apply(x, round_tf32)
