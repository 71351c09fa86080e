"""Spherical-harmonic synthesis on the HEALPix sphere and on Gauss-Legendre
grids (counterpart of ``nifty_tpu/ops/sht.py``).

Conventions as the JAX package's: real orthonormal spherical harmonics
with the Condon-Shortley phase, the coefficients in the packed real-alm
layout (all m = 0 coefficients for l = 0..lmax first, then for each
m ≥ 1 the interleaved (re, im) pairs for l = m..lmax), the synthesis
scaled by √(4π) so that an l-flat unit spectrum has unit field variance.

Two stages:

1. **Legendre** — :class:`LegendreContract`, the port's counterpart of the
   JAX package's primitive ``nifty_legendre_contract``: K5 on the card
   (:mod:`.cuda_legendre`), its adjoint :class:`LegendreContractT` (K6).
   Each Function is the other's backward and its own jvp (both are linear
   in the coefficients; the grid is a constant of the plan, so nothing
   differentiates with respect to it), and under ``torch.func.vmap`` the
   mapped axis joins the kernels' batch: one launch per batch.
2. **Ring Fourier** — the ring coefficients, weighted and phase-shifted to
   each ring's first pixel, are summed over m on each ring: the 2 nside + 1
   rings of the equatorial belt (4 nside pixels each) by one batched
   ``ifft``; the 2 (nside - 1) polar-cap rings (4k pixels on ring k) by one
   factored direct DFT over all of them at once (m = m1 + S m2: a batched
   matrix product over m1 against ``exp(i m1 φ)`` and a weighted sum over
   m2 against ``exp(i S m2 φ)``, every ring padded to the longest, the
   tables made once in float64 with the angles reduced mod 2π).  The
   belt's and the caps' values reach the RING-ordered map through one
   precomputed index, whose adjoint is a gather by the inverse index, so
   the whole transpose is deterministic.

Everything is linear in the coefficients; the adjoint is autograd's
(``torch.func.vjp``), which runs K6.  :class:`HealpixSynthesis` (and
:class:`GaussLegendreSynthesis`) hold their tables as buffers: a model
registers one as a submodule and ``.to`` moves it; the functional forms
(:func:`healpix_synthesis`, ...) build one per grid, device and dtype and
keep the last one of each class until :func:`clear_cache`.
"""

from __future__ import annotations


import numpy as np
import torch

from .. import device as _device
from ..conjugate_gradient import static_cg
from . import cuda_legendre as cl
from .cuda_legendre import LegendrePlan, alm_size, real_alm_index_maps

__all__ = [
    "GaussLegendreSynthesis",
    "HealpixSynthesis",
    "LegendreContract",
    "LegendreContractT",
    "clear_cache",
    "gauss_legendre_analysis",
    "gauss_legendre_grid",
    "gauss_legendre_synthesis",
    "get_healpix_synthesis",
    "healpix_analysis",
    "healpix_ring_geometry",
    "healpix_synthesis",
    "unpack_real_alm",
]


# --- static geometry (numpy, construction time) -----------------------------


def healpix_ring_geometry(nside: int):
    """Rings of the RING-ordered HEALPix grid (Górski et al. 2005), north to
    south: cos θ, the pixel count, the first pixel's φ and the flat start
    index of each ring."""
    nside = int(nside)
    ring = np.arange(1, 4 * nside, dtype=np.int64)
    north, south = ring < nside, ring > 3 * nside
    ring_s = 4 * nside - ring
    z = np.where(north, 1.0 - ring**2 / (3.0 * nside**2),
                 np.where(south, -(1.0 - ring_s**2 / (3.0 * nside**2)),
                          4.0 / 3.0 - 2.0 * ring / (3.0 * nside)))
    nphi = np.where(north, 4 * ring, np.where(south, 4 * ring_s, 4 * nside))
    shifted = ((ring - nside + 1) % 2) * np.pi / (4.0 * nside)
    with np.errstate(divide="ignore"):
        phi0 = np.where(north, np.pi / (4.0 * ring),
                        np.where(south, np.pi / (4.0 * ring_s), shifted))
    start = np.concatenate([[0], np.cumsum(nphi)[:-1]])
    return z, nphi, phi0, start


def unpack_real_alm(x, lmax: int, mmax: int):
    """Packed real alm ``(..., size)`` -> dense ``(..., lmax+1, mmax+1)``
    cosine and sine coefficient matrices."""
    idx_re, msk_re, idx_im, msk_im = real_alm_index_maps(lmax, mmax)

    def dense(idx, msk):
        vals = x[..., torch.as_tensor(idx, device=x.device)]
        return vals * torch.as_tensor(msk, dtype=x.dtype, device=x.device)

    return dense(idx_re, msk_re), dense(idx_im, msk_im)


def _synthesis_weights(mmax: int):
    """The real basis' weights (1 at m = 0, √2 above) times √(4π)."""
    w = np.full(mmax + 1, np.sqrt(2.0))
    w[0] = 1.0
    return w * np.sqrt(4.0 * np.pi)


def _complex_buffer(module, name, values):
    """Register complex ``values`` as a real ``(..., 2)`` buffer: ``.to``
    casts it as a float and :func:`torch.view_as_complex` reads it."""
    module.register_buffer(name, torch.from_numpy(
        np.ascontiguousarray(np.stack([values.real, values.imag], axis=-1))))


# --- the Legendre stage: K5 and K6 -------------------------------------------


class LegendreContract(torch.autograd.Function):
    """``alm`` (B, size) -> ring coefficients (B, R, mmax+1, 2), through K5."""

    @staticmethod
    def forward(alm, plan):
        if plan.cos_half.requires_grad:
            raise NotImplementedError("the Legendre contraction is not differentiable w.r.t. the grid")
        if alm.is_meta:
            return alm.new_empty((alm.shape[0], plan.n_rings, plan.mmax + 1, 2))
        return cl.legendre_contract(alm.contiguous(), plan)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.plan = inputs[1]

    @staticmethod
    def backward(ctx, grad):
        return LegendreContractT.apply(grad, ctx.plan), None

    @staticmethod
    def jvp(ctx, alm_t, _):
        return LegendreContract.apply(alm_t, ctx.plan)

    @staticmethod
    def vmap(info, in_dims, alm, plan):
        x = alm.movedim(in_dims[0], 0)
        out = LegendreContract.apply(x.reshape((-1,) + x.shape[2:]), plan)
        return out.reshape(x.shape[:2] + out.shape[1:]), 0


class LegendreContractT(torch.autograd.Function):
    """Ring cotangents (B, R, mmax+1, 2) -> packed alm (B, size), through K6."""

    @staticmethod
    def forward(cot, plan):
        if cot.is_meta:
            return cot.new_empty((cot.shape[0], plan.size))
        return cl.legendre_contract_t(cot.contiguous(), plan)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.plan = inputs[1]

    @staticmethod
    def backward(ctx, grad):
        return LegendreContract.apply(grad, ctx.plan), None

    @staticmethod
    def jvp(ctx, cot_t, _):
        return LegendreContractT.apply(cot_t, ctx.plan)

    @staticmethod
    def vmap(info, in_dims, cot, plan):
        x = cot.movedim(in_dims[0], 0)
        out = LegendreContractT.apply(x.reshape((-1,) + x.shape[2:]), plan)
        return out.reshape(x.shape[:2] + out.shape[1:]), 0


def _ring_coefficients(alm, plan):
    """K5's output read as complex ``f_c + i f_s``, (B, R, mmax+1), without a copy."""
    return torch.view_as_complex(LegendreContract.apply(alm, plan))


# --- the map assembly: a gather whose adjoint is a gather -------------------


class _Gather(torch.autograd.Function):
    """``x[..., index]`` for an injective ``index``; the backward gathers by
    ``inverse`` (``len(index)`` where a place of ``x`` is not gathered)."""

    generate_vmap_rule = True

    @staticmethod
    def forward(x, index, inverse):
        return x.index_select(-1, index)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.index, ctx.inverse = inputs[1], inputs[2]

    @staticmethod
    def backward(ctx, grad):
        return _Scatter.apply(grad, ctx.index, ctx.inverse), None, None

    @staticmethod
    def jvp(ctx, x_t, *_):
        return _Gather.apply(x_t, ctx.index, ctx.inverse)


class _Scatter(torch.autograd.Function):
    """The adjoint of :class:`_Gather`: a zero-padded gather by ``inverse``."""

    generate_vmap_rule = True

    @staticmethod
    def forward(y, index, inverse):
        padded = torch.cat([y, y.new_zeros(y.shape[:-1] + (1,))], dim=-1)
        return padded.index_select(-1, inverse)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.index, ctx.inverse = inputs[1], inputs[2]

    @staticmethod
    def backward(ctx, grad):
        return _Gather.apply(grad, ctx.index, ctx.inverse), None, None

    @staticmethod
    def jvp(ctx, y_t, *_):
        return _Scatter.apply(y_t, ctx.index, ctx.inverse)


def _ring_sum(h, n):
    """``Re Σ_m h_m exp(2πi m j / n)`` for j < n, by one ``ifft``."""
    return torch.fft.ifft(h, n=n, dim=-1, norm="forward").real


class _AxisTransform(torch.nn.Module):
    """Apply :meth:`_flat` ((B, n_in) -> (B, n_out)) along ``axis``, every
    other axis flattened into the batch."""

    def forward(self, x):
        axis = self.axis % x.ndim
        y = x.movedim(axis, -1)
        lead = y.shape[:-1]
        out = self._flat(y.reshape((-1, y.shape[-1])))
        return out.reshape(lead + out.shape[-1:]).movedim(-1, axis)


class HealpixSynthesis(_AxisTransform):
    """Packed real alm along ``axis`` -> the RING-ordered HEALPix map of
    12 nside² pixels (``lmax`` 2 nside and ``mmax`` ``lmax`` by default).
    Built with float64 tables on the CPU; ``.to`` moves and casts it."""

    def __init__(self, nside: int, lmax=None, mmax=None, axis: int = -1):
        super().__init__()
        nside = int(nside)
        lmax = 2 * nside if lmax is None else int(lmax)
        mmax = lmax if mmax is None else int(mmax)
        n_eq = 4 * nside
        if mmax >= n_eq:
            raise ValueError(f"mmax {mmax} aliases on the equatorial rings (4 nside = {n_eq})")
        self.nside, self.lmax, self.mmax, self.axis = nside, lmax, mmax, int(axis)
        self.size, self.npix = alm_size(lmax, mmax), 12 * nside * nside
        z, nphi, phi0, start = healpix_ring_geometry(nside)
        self.plan = LegendrePlan(z, lmax, mmax)
        ms = np.arange(mmax + 1)
        _complex_buffer(self, "phase",
                        _synthesis_weights(mmax)[None, :] * np.exp(1j * ms[None, :] * phi0[:, None]))
        self.n_eq, self.belt = n_eq, (nside - 1, 3 * nside)  # rings [lo, hi)
        cap = np.concatenate([np.arange(nside - 1), np.arange(3 * nside, 4 * nside - 1)])
        self.register_buffer("cap_rings", torch.from_numpy(cap))
        M = mmax + 1
        self.S = int(np.ceil(np.sqrt(M)))
        self.M2 = -(-M // self.S)
        L = int(nphi[cap].max()) if cap.size else 0
        self.L = L
        if cap.size:
            # the angles of each cap pixel from its ring's first pixel (the
            # first pixel's φ is in `phase`), reduced mod 2π in float64
            theta = 2.0 * np.pi * np.arange(L)[None, :] / nphi[cap][:, None]

            def table(k):
                return np.exp(1j * np.mod(k[None, :, None] * theta[:, None, :], 2.0 * np.pi))

            _complex_buffer(self, "e1", table(np.arange(self.S, dtype=np.float64)))
            _complex_buffer(self, "e2", table(self.S * np.arange(self.M2, dtype=np.float64)))
        # map pixel -> place in [caps (Rc, L) | belt (n_belt, 4 nside)], and back
        ring_of = np.repeat(np.arange(z.size), nphi)
        j = np.arange(self.npix) - start[ring_of]
        cap_pos = np.full(z.size, -1)
        cap_pos[cap] = np.arange(cap.size)
        lo, hi = self.belt
        index = np.where(cap_pos[ring_of] >= 0, cap_pos[ring_of] * L + j,
                         cap.size * L + (ring_of - lo) * n_eq + j)
        inverse = np.full(cap.size * L + (hi - lo) * n_eq, self.npix, dtype=np.int64)
        inverse[index] = np.arange(self.npix)
        self.register_buffer("index", torch.from_numpy(index.astype(np.int64)))
        self.register_buffer("inverse", torch.from_numpy(inverse))

    def _flat(self, alm):
        B = alm.shape[0]
        h = _ring_coefficients(alm, self.plan) * torch.view_as_complex(self.phase)
        lo, hi = self.belt
        parts = [_ring_sum(h[:, lo:hi], self.n_eq).reshape(B, -1)]
        if self.L:
            pad = self.M2 * self.S - h.shape[-1]
            hc = h.index_select(1, self.cap_rings)
            hc = torch.cat([hc, hc.new_zeros(hc.shape[:2] + (pad,))], dim=-1)
            z = torch.matmul(hc.reshape(hc.shape[:2] + (self.M2, self.S)),
                             torch.view_as_complex(self.e1))  # (B, Rc, M2, L)
            caps = (z * torch.view_as_complex(self.e2)).sum(-2).real
            parts.insert(0, caps.reshape(B, -1))
        return _Gather.apply(torch.cat(parts, dim=1), self.index, self.inverse)


def gauss_legendre_grid(lmax: int, n_phi=None):
    """The Gauss-Legendre sphere: ``lmax+1`` rings at the Legendre nodes
    (exact quadrature to degree 2 lmax + 1), north to south, ``n_phi``
    equidistant pixels each (2 lmax + 2 by default).  Returns (cos θ
    nodes, quadrature weights, n_phi)."""
    nodes, weights = np.polynomial.legendre.leggauss(int(lmax) + 1)
    n_phi = 2 * int(lmax) + 2 if n_phi is None else int(n_phi)
    return nodes[::-1].copy(), weights[::-1].copy(), n_phi


class GaussLegendreSynthesis(_AxisTransform):
    """Packed real alm along ``axis`` -> the (lmax+1, n_phi) Gauss-Legendre
    map, flattened ring by ring.  An odd ``lmax`` (an even ring count, no
    equator ring) folds as an odd one does."""

    def __init__(self, lmax: int, mmax=None, n_phi=None, axis: int = -1):
        super().__init__()
        lmax = int(lmax)
        mmax = lmax if mmax is None else int(mmax)
        z, _, n_phi = gauss_legendre_grid(lmax, n_phi)
        if mmax >= n_phi:
            raise ValueError("n_phi must exceed mmax (no aliasing allowed)")
        self.lmax, self.mmax, self.n_phi, self.axis = lmax, mmax, n_phi, int(axis)
        self.plan = LegendrePlan(z, lmax, mmax)
        self.register_buffer("weights", torch.from_numpy(_synthesis_weights(mmax)))

    def _flat(self, alm):
        h = _ring_coefficients(alm, self.plan) * self.weights
        return _ring_sum(h, self.n_phi).reshape(alm.shape[0], -1)


_last = {}  # class -> ((args, device, dtype), module): the last one built of each class


def _built(cls, args, device, dtype):
    """``cls(*args)`` on ``device`` in ``dtype``.  The functional forms keep
    the last module built of each class (its tables: at nside 512 a
    synthesis holds about 0.55 GB of them on the card) for the next call
    with the same arguments; :func:`clear_cache` frees them.  A caller
    that alternates between grids holds its own module
    (:func:`get_healpix_synthesis`, :class:`HealpixSynthesis`)."""
    key = (args, device, dtype)
    hit = _last.get(cls)
    if hit is None or hit[0] != key:
        _last[cls] = hit = (key, cls(*args).to(device=device, dtype=dtype))
    return hit[1]


def clear_cache():
    """Free the modules that the functional forms (:func:`healpix_synthesis`,
    :func:`healpix_analysis`, :func:`gauss_legendre_synthesis`,
    :func:`gauss_legendre_analysis`) keep between calls."""
    _last.clear()


def healpix_synthesis(alm, nside: int, lmax=None, mmax=None):
    """Packed real alm ``(..., size)`` -> RING-ordered HEALPix map
    ``(..., 12 nside²)``, on ``alm``'s device."""
    return _built(HealpixSynthesis, (int(nside), lmax, mmax), alm.device, alm.dtype)(alm)


def get_healpix_synthesis(nside, axis, lmax, mmax, device=None, dtype=torch.float32):
    """The synthesis over ``axis`` of an array, every other axis a batch
    (one K5 launch for all of them), as a module on ``device`` (the CUDA
    card by default)."""
    return HealpixSynthesis(nside, lmax, mmax, axis).to(device=_device.resolve(device), dtype=dtype)


def gauss_legendre_synthesis(alm, lmax: int, mmax=None, n_phi=None):
    """Real-alm synthesis onto the Gauss-Legendre grid: ``(..., size)`` ->
    ``(..., lmax+1, n_phi)``."""
    trafo = _built(GaussLegendreSynthesis, (int(lmax), mmax, n_phi), alm.device, alm.dtype)
    return trafo(alm).reshape(alm.shape[:-1] + (trafo.lmax + 1, trafo.n_phi))


def gauss_legendre_analysis(f, lmax: int, mmax=None):
    """The exact inverse of :func:`gauss_legendre_synthesis` for band-limited
    maps ``(lmax+1, n_phi)``: the ring FFT, then the quadrature-weighted
    Legendre projection (K6)."""
    lmax = int(lmax)
    mmax = lmax if mmax is None else int(mmax)
    z, wq, n_phi = gauss_legendre_grid(lmax, f.shape[-1])
    plan = _built(LegendrePlan, (tuple(z), lmax, mmax), f.device, f.dtype)
    w = _synthesis_weights(mmax)
    # the m >= 1 columns carry ∮cos² dφ = π, not 2π: 2 (2π / n_phi) / w_m
    scale = np.where(np.arange(mmax + 1) == 0, 1.0, 2.0) * (2.0 * np.pi / n_phi) / w
    ft = torch.fft.fft(f, dim=-1)[..., : mmax + 1]
    g = ft * torch.as_tensor(scale, dtype=f.dtype, device=f.device) * torch.as_tensor(
        wq, dtype=f.dtype, device=f.device)[:, None]
    return LegendreContractT.apply(torch.view_as_real(g)[None], plan)[0]


def healpix_analysis(m, nside: int, lmax=None, mmax=None, *, iterations: int = 3):
    """Map -> packed real alm, the least-squares inverse of
    :func:`healpix_synthesis`: conjugate gradient on the normal equations
    ``Sᵀ S alm = Sᵀ m`` (weighted by 4π / npix), from ``Sᵀ m``, until the
    residual is below 1e-6 of the right-hand side or after
    ``10 iterations`` steps.  Sᵀ is the synthesis' pull-back (K6)."""
    synth = _built(HealpixSynthesis, (int(nside), lmax, mmax), m.device, m.dtype)
    w = 4.0 * np.pi / synth.npix
    _, pull = torch.func.vjp(synth, m.new_zeros(synth.size))

    def wadj(x):
        return w * pull(x)[0]

    b = wadj(m)
    res = static_cg(lambda a: wadj(synth(a)), b, x0=b, maxiter=max(int(iterations), 1) * 10,
                    resnorm=1e-6 * torch.linalg.vector_norm(b), miniter=2)
    return res.x
