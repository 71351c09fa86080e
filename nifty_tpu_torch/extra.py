"""Consistency checks for models, linear maps and likelihoods (counterpart
of ``nifty_tpu/extra.py``).

Adjointness of a linear map's transpose against explicit inner products,
Jacobian (jvp/vjp) agreement with finite differences, and the likelihood
metric identity ``metric ≡ lsm ∘ rsm``, on the port's trees.  The
transpose of a linear map is ``torch.func.vjp`` with the conjugation that
``jax.linear_transpose`` implies: ``conj(vjp(conj(y)))`` (torch's vjp of a
complex map is conjugate-Wirtinger).

:func:`no_host_transfers` is the counterpart of ``jax.transfer_guard``,
on ``torch.cuda.set_sync_debug_mode``: ``"disallow"`` raises and
``"log"`` warns at an operation that synchronises the host with the card
(a device-to-host copy such as ``.item()``, ``nonzero``).  Torch sees
those syncs only: an implicit upload of a host constant is no sync and
passes unseen, where JAX's guard would catch it.
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Callable

import numpy as np
import torch
from torch.utils._pytree import tree_flatten

from . import device as _device
from .likelihood import Likelihood
from .utils.tree import ShapeWithDtype, random_like, tree_map, vdot

__all__ = [
    "check_no_host_transfers",
    "no_host_transfers",
    "assert_allclose",
    "check_linear_model",
    "check_model_jacobian",
    "check_likelihood_metrics",
]


def assert_allclose(a, b, *, rtol=1e-7, atol=0.0):
    la, sa = tree_flatten(a)
    lb, sb = tree_flatten(b)
    if sa != sb:
        raise AssertionError(f"tree structures differ: {sa} vs {sb}")
    for x, y in zip(la, lb):
        np.testing.assert_allclose(_numpy(x), _numpy(y), rtol=rtol, atol=atol)


def _numpy(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _generator(key, device):
    if isinstance(key, torch.Generator):
        return key
    return torch.Generator(device=device).manual_seed(int(key))


def _conj(t):
    return t.conj().resolve_conj() if t.is_complex() else t


def _device_of(tree):
    return tree_flatten(tree)[0][0].device


def check_linear_model(f: Callable, domain, key, *, rtol=1e-6, atol=0.0, device=None):
    """Verify ``f`` is linear and its transpose its adjoint:
    ``f(αx₁+x₂) == αf(x₁)+f(x₂)`` and ``⟨y, f(x)⟩ == ⟨fᵀ(y), x⟩``.
    ``domain`` is a tree of :class:`ShapeWithDtype`; ``key`` a
    ``torch.Generator`` or an integer seed; draws on ``device`` (the CUDA
    card by default)."""
    device = _device.resolve(device)
    gen = _generator(key, device)
    x1 = random_like(gen, domain, device=device)
    x2 = random_like(gen, domain, device=device)

    alpha = 1.7
    lhs = f(tree_map(lambda a, b: alpha * a + b, x1, x2))
    rhs = tree_map(lambda a, b: alpha * a + b, f(x1), f(x2))
    assert_allclose(lhs, rhs, rtol=rtol, atol=atol)

    out, vjp_fn = torch.func.vjp(f, x1)
    y = random_like(gen, tree_map(ShapeWithDtype.from_leave, out), device=device)
    ft_y = tree_map(_conj, vjp_fn(tree_map(_conj, y))[0])
    np.testing.assert_allclose(_numpy(vdot(y, f(x1))), _numpy(vdot(ft_y, x1)), rtol=rtol, atol=atol)


def check_model_jacobian(model: Callable, pos, key, *, step=1e-4, rtol=1e-4, atol=1e-6):
    """Verify the jvp against central finite differences along a random
    tangent, and ``⟨J t, c⟩ == ⟨t, Jᵀ c⟩`` for a random cotangent."""
    gen = _generator(key, _device_of(pos))
    shapes = lambda t: tree_map(ShapeWithDtype.from_leave, t)  # noqa: E731
    tangent = random_like(gen, shapes(pos), device=_device_of(pos))

    _, jvp_val = torch.func.jvp(model, (pos,), (tangent,))
    p_plus = tree_map(lambda p, t: p + step * t, pos, tangent)
    p_minus = tree_map(lambda p, t: p - step * t, pos, tangent)
    fd = tree_map(lambda a, b: (a - b) / (2 * step), model(p_plus), model(p_minus))
    assert_allclose(jvp_val, fd, rtol=rtol, atol=atol)

    out, vjp_fn = torch.func.vjp(model, pos)
    cotangent = random_like(gen, shapes(out), device=_device_of(out))
    lhs = vdot(cotangent, jvp_val)
    rhs = vdot(tree_map(_conj, vjp_fn(tree_map(_conj, cotangent))[0]), tangent)
    np.testing.assert_allclose(_numpy(lhs), _numpy(rhs), rtol=1e-6, atol=1e-9)


def check_likelihood_metrics(lh: Likelihood, pos, key, *, rtol=1e-6, atol=1e-9):
    """Verify the likelihood metric identities at ``pos``:
    ``metric(t) == lsm(rsm(t))`` and the symmetry ⟨t₁, M t₂⟩ == ⟨M t₁, t₂⟩."""
    gen = _generator(key, _device_of(pos))
    shapes = tree_map(ShapeWithDtype.from_leave, pos)
    t1 = random_like(gen, shapes, device=_device_of(pos))
    t2 = random_like(gen, shapes, device=_device_of(pos))

    met = lh.metric(pos, t1)
    via_sqrt = lh.left_sqrt_metric(pos, lh.right_sqrt_metric(pos, t1))
    assert_allclose(met, via_sqrt, rtol=rtol, atol=atol)
    lhs = vdot(t2, lh.metric(pos, t1))
    rhs = vdot(lh.metric(pos, t2), t1)
    np.testing.assert_allclose(_numpy(lhs), _numpy(rhs), rtol=rtol, atol=atol)


_SYNC_MODES = {"allow": "default", "log": "warn", "disallow": "error",
               "log_explicit": "warn", "disallow_explicit": "error"}


@contextmanager
def no_host_transfers(level: str = "disallow"):
    """Fail (``"disallow"``) or warn (``"log"``) at a host-device sync on the
    card inside the context (``torch.cuda.set_sync_debug_mode``); the
    ``*_explicit`` levels are the same, as torch does not tell an explicit
    copy from an implicit one.  Implicit uploads are not syncs and pass.
    Without a card the context only checks ``level``.

    Usage::

        with no_host_transfers():
            lh.metric(p, t)
    """
    if level not in _SYNC_MODES:
        raise ValueError(f"level must be one of {sorted(_SYNC_MODES)}")
    if not torch.cuda.is_available():
        yield
        return
    before = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode(_SYNC_MODES[level])
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(before)


def check_no_host_transfers(fn, *args, **kwargs):
    """Run ``fn(*args, **kwargs)`` under :func:`no_host_transfers` and wait
    for the card (outside the context: the wait is a sync itself)."""
    with no_host_transfers():
        out = fn(*args, **kwargs)
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return out
