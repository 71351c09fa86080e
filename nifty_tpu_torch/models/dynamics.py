"""Dynamical-field priors: causal Green's functions and light cones
(counterpart of ``nifty_tpu/models/dynamics.py``).

A learned transfer function G(ω, k) built from a smoothness-weighted
latent field, made causal by zeroing the negative-time part of its kernel
(the cepstral construction for minimum-phase filters), optionally
confined to a learned light cone exp(−½ Re√((x/σc)²−t²)²).  The
arithmetic runs in complex128 whatever the latents' dtype, and a model's
output is rounded once, to complex64 for float32 latents: the transfer
field is 1/m (or exp of a projection of log m) for a Gaussian field m,
and near the zeros of m float32's rounding is a large relative error;
near the cone's edge t² and Σ c x² cancel.  torch's autograd
differentiates the cone and the cepstrum.

The models map real latents to complex fields: torch's vjp with a
cotangent ``c`` equals ``jax.vjp``'s with ``conj(c)`` (the same gradient
of a real loss).
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import numpy as np
import torch

from ..device import Const
from ..model import Model
from ..utils.tree import ShapeWithDtype, random_like

__all__ = [
    "signed_fft_coords",
    "light_cone",
    "dynamic_operator",
    "dynamic_lightcone_operator",
]


def signed_fft_coords(shape, distances, absolute=False):
    """Per-axis signed coordinates in FFT layout: entry ``j`` carries
    ``min(j, N−j)·d`` with the upper half negated (numpy)."""
    dim = len(shape)
    out = np.zeros((dim,) + tuple(shape))
    for i, (n, d) in enumerate(zip(shape, distances)):
        ks = np.minimum(np.arange(n), n - np.arange(n)).astype(float) * d
        if not absolute:
            ks[n // 2 + 1 :] *= -1.0
        bshape = (1,) * i + (n,) + (1,) * (dim - i - 1)
        out[i] += ks.reshape(bshape)
    return out


def _complex(dtype):
    return torch.complex64 if dtype == torch.float32 else torch.complex128


def _cone_terms(shape, distances, sigx):
    """The squared scaled coordinates ``(x_i/(σ_x d_i))²`` of each axis, as
    :class:`~..device.Const` objects."""
    x = signed_fft_coords(shape, distances)
    return [Const((x[i] / (sigx * distances[i])) ** 2) for i in range(len(shape))]


def _cone(lightspeeds, terms):
    """The window in float64."""
    c = lightspeeds.double()
    a = (-terms[0].like(c)).to(torch.complex128)
    for i in range(1, len(terms)):
        a = a + c[i - 1] * terms[i].like(c)
    # guard the sqrt branch point at a = 0 (the grid origin) so AD stays
    # finite: the cone there is 1 with zero sensitivity
    small = a.abs() < 1e-20
    a_safe = torch.where(small, torch.ones_like(a), a)
    root = torch.sqrt(a_safe).real
    delta = torch.where(small, torch.zeros_like(root), root)
    return torch.exp(-0.5 * delta**2)


def light_cone(lightspeeds, shape, distances, sigx: float):
    """Light-cone window on a (t, x…) grid, axis 0 time:
    ``exp(−½ Re√(Σ_i c_i (x_i/(σ_x d_i))² − (t/(σ_x d_t))²)²)``, one for
    space-like separations, a Gaussian fall-off outside the cone.
    Differentiable in the lightspeeds ``c`` (a tensor); in their dtype."""
    return _cone(lightspeeds, _cone_terms(shape, distances, sigx)).to(lightspeeds.dtype)


def _central_crop(x, shape):
    """Crop an FFT-layout (padded-harmonic) array back to ``shape`` by
    removing the central high-frequency block of each axis."""
    for ax, (n_p, n) in enumerate(zip(x.shape, shape)):
        if n_p == n:
            continue
        lo = (n + 1) // 2
        hi = n - lo
        x = torch.cat([x.narrow(ax, 0, lo), x.narrow(ax, n_p - hi, hi)], dim=ax)
    return x


def _dynamics(shape, distances, key, sm_s0, sm_x0, harmonic_padding, causal, minimum_phase):
    """The transfer field and the smoothed dynamics in complex128, the
    padded shape and the numpy weights."""
    ndim = len(shape)
    if harmonic_padding is None:
        pad = (0,) * ndim
    elif isinstance(harmonic_padding, int):
        pad = (harmonic_padding,) * ndim
    else:
        pad = tuple(int(p) for p in harmonic_padding)
    pshape = tuple(n + p for n, p in zip(shape, pad))
    sm_x0 = tuple(np.broadcast_to(np.asarray(sm_x0, float), (ndim,)))

    # smoothness weight in signed index units of the padded grid
    idx = signed_fft_coords(pshape, (1.0,) * ndim)
    denom = 1.0
    for i in range(ndim):
        denom = denom + (idx[i] / sm_x0[i]) ** 2
    sm_weight = np.asarray(sm_s0 / denom)

    # time-axis causal mask (1 + sign(t): doubles positive times, zeroes
    # negative ones; t is FFT-layout axis 0 of the *original* grid)
    t = signed_fft_coords(shape, distances)[0]
    causal_mask = np.asarray(1.0 + np.sign(t))
    weight, mask = Const(sm_weight), Const(causal_mask)

    def smoothed(x):
        xi = x[key].double()
        return _central_crop(torch.fft.fftn(weight.like(xi) * xi), shape)

    def transfer(x):
        m = -torch.log(smoothed(x))
        if not minimum_phase:
            m = torch.exp(m)
        if causal or minimum_phase:
            m = torch.fft.fftn(torch.fft.ifftn(m) * mask.like(m))
        if minimum_phase:
            m = torch.exp(m)
        return m

    return transfer, smoothed, pshape, sm_weight, causal_mask


def dynamic_operator(*, shape: Tuple[int, ...], distances, key: str, sm_s0: float, sm_x0,
                     harmonic_padding=None, causal: bool = True, minimum_phase: bool = False):
    """Model of a (causal) Green's-function transfer field G(ω, k).

    The latent white field (under ``key``, on the harmonically padded grid)
    is weighted toward smooth transfer functions by ``sm_s0 / (1 + Σ
    (j_i/sm_x0_i)²)`` in index units, Fourier-transformed, cropped and, for
    ``causal``/``minimum_phase``, passed through the cepstral truncation
    that zeroes the kernel at negative times.

    Returns ``(model, ops)``: ``model(x)`` is the complex transfer field on
    the (ω, k) grid of ``shape``, ``ops`` the intermediate callables and
    the numpy weights."""
    shape = tuple(int(s) for s in shape)
    distances = tuple(np.broadcast_to(np.asarray(distances, float), (len(shape),)))
    transfer, smoothed, pshape, sm_weight, causal_mask = _dynamics(
        shape, distances, key, sm_s0, sm_x0, harmonic_padding, causal, minimum_phase)

    def rounded(fn):
        return lambda x: fn(x).to(_complex(x[key].dtype))

    domain = {key: ShapeWithDtype(pshape)}
    model = Model(rounded(transfer), domain=domain,
                  init={key: partial(random_like, primals=domain[key])})
    ops = {
        "smoothed_dynamics": rounded(smoothed),
        "causal_mask": causal_mask,
        "smoothness_weight": sm_weight,
    }
    return model, ops


def dynamic_lightcone_operator(*, shape, distances, key: str, lightcone_key: str, sm_s0: float,
                               sm_x0, sigc, quant: float, harmonic_padding=None,
                               causal: bool = True, minimum_phase: bool = False):
    """Green's-function model confined to a learned light cone (axis 0
    time; needs ndim ≥ 2).  The lightspeeds are log-normal in the latent
    under ``lightcone_key``.

    Returns ``(model, ops)`` with ``ops['lightspeed']`` the learned speeds
    and ``ops['light_cone']`` the window."""
    shape = tuple(int(s) for s in shape)
    ndim = len(shape)
    if ndim < 2:
        raise ValueError("a light cone needs at least one spatial axis")
    distances = tuple(np.broadcast_to(np.asarray(distances, float), (ndim,)))
    sigc = np.array(np.broadcast_to(np.asarray(sigc, float), (ndim - 1,)))

    transfer, smoothed, pshape, sm_weight, causal_mask = _dynamics(
        shape, distances, key, sm_s0, sm_x0, harmonic_padding, causal, minimum_phase)
    sigc, ratio = Const(sigc), Const(np.asarray(distances[1:]) / distances[0])
    terms = _cone_terms(shape, distances, quant)

    def lightspeed(x):
        q = x[lightcone_key]
        return torch.exp(-0.5 * sigc.like(q, q.dtype) * q) * ratio.like(q, q.dtype)

    def cone(x):
        q = x[lightcone_key].double()
        return _cone(torch.exp(sigc.like(q) * q), terms)

    def model_fn(x):
        return (cone(x) * transfer(x)).to(_complex(x[key].dtype))

    domain = {key: ShapeWithDtype(pshape), lightcone_key: ShapeWithDtype((ndim - 1,))}
    domain = {k: domain[k] for k in sorted(domain)}  # JAX's order of dict keys
    init = {k: partial(random_like, primals=v) for k, v in domain.items()}
    model = Model(model_fn, domain=domain, init=init)
    ops = {
        "smoothed_dynamics": lambda x: smoothed(x).to(_complex(x[key].dtype)),
        "causal_mask": causal_mask,
        "smoothness_weight": sm_weight,
        "lightspeed": lightspeed,
        "light_cone": lambda x: cone(x).to(x[lightcone_key].dtype),
    }
    return model, ops
