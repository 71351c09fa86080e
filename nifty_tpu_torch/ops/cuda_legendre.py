"""The Legendre contraction of the spherical-harmonic synthesis on the card:
K5 (packed real alm -> ring coefficients) and K6 (its adjoint).

They replace the JAX package's own XLA primitive
``nifty_tpu/ops/sht.py:338`` (``nifty_legendre_contract``, not a Pallas
kernel): a ``lax.scan`` over l that generates the normalised associated
Legendre functions λ_{l,m}(θ_r) by the stable three-term recurrence
λ_{l,m} = a_{l,m} cos θ λ_{l-1,m} - b_{l,m} λ_{l-2,m}, seeded on the
diagonal λ_{m,m} = λ_00 Π_{k≤m} dfac_k sin θ, and contracts them with the
coefficients at once, on the northern half of a north/south symmetric
ring grid (λ_{l,m}(π-θ) = (-1)^{l+m} λ_{l,m}(θ)):

    K5: F[b, r, m] = Σ_l λ_{l,m}(θ_r) c[b, l, m],  its mirror ring with
        the parity sign, for the cosine and the sine coefficients;
    K6: g[b, l, m] = Σ_r λ_{l,m}(θ_r) (G[b, r, m] + (-1)^{l+m} G[b, R-1-r, m]).

Both read and write the packed real-alm layout (all m = 0 coefficients
first, then for each m ≥ 1 the (re, im) pairs for l = m..lmax) and the
ring side as ``(B, R, mmax+1, 2)``: (cosine, sine) interleaved, which
``torch.view_as_complex`` reads as ``f_c + i f_s`` without a copy.
``csrc/legendre.cu`` says how the kernels are laid out; the recurrence
runs in float64 in both the kernels and the plain versions (float32
underflows the seed at nside ≥ 256), the contraction in the coefficients'
dtype (on the float64 tensor cores for batches of :data:`MMA_MIN_BATCH`
or more, rounded once).

:class:`LegendrePlan` holds the tables of one ring grid: float64 buffers
that stay float64 under ``.to(dtype)``, and the column pairs a block of
either kernel walks (:func:`column_pairs`).  :func:`launch_config` is the
launch each wrapper makes.  Each wrapper runs its plain PyTorch version (a
loop over l) when its tensor lies on the CPU; for a CUDA tensor it
launches its kernel or raises.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import native
from ..device import Float64Tables

__all__ = [
    "MMA_MIN_BATCH",
    "LaunchConfig",
    "LegendrePlan",
    "alm_size",
    "column_pairs",
    "launch_config",
    "legendre_contract",
    "legendre_contract_plain",
    "legendre_contract_t",
    "legendre_contract_t_plain",
    "real_alm_index_maps",
    "recurrence_tables",
]

# batches from this size on take the tensor-core kernels (csrc/legendre.cu, designs 4-5)
MMA_MIN_BATCH = 8


class LaunchConfig(NamedTuple):
    """A launch of K5 or K6 (grid x: ring chunks, y: column groups, z:
    sample groups): ``mma`` (the tensor-core kernel), ``rings_per_thread``
    K, ``threads`` a block, ``n_chunks``, ``columns`` a block (0: the pair
    ``plan.pairs[y]``; else ``columns`` consecutive columns from
    ``columns y``, one a warp, over 32 rings, lane r taking ring 32 x + r),
    ``samples`` a block."""

    mma: bool
    rings_per_thread: int
    threads: int
    n_chunks: int
    columns: int
    samples: int


def launch_config(plan, B: int, transpose: bool = False) -> LaunchConfig:
    """The launch of K5 (``transpose`` False) or K6 for a batch of ``B``
    (``csrc/legendre.cu``'s constants).  On the CUDA cores block y walks the
    column pair ``plan.pairs[y]``, thread ``tid`` of ring chunk c the rings
    (c K + k) threads + tid, k < K, with up to 256 threads, 4 samples a
    block and K (2 or 4) as the card's sweep chose it
    (``bench/legendre_bench.py --k-sweep``).  On the tensor cores (B >=
    :data:`MMA_MIN_BATCH`), 8 samples a block: K5 takes 8 consecutive
    columns a block, a warp each, over 32 rings; K6 a pair, K = 1 ring a
    thread up to 256 northern rings and 2 above, as on the CUDA cores.  K6
    reduces a chunk's rings in the block: more than one chunk (over 1,024
    northern rings on the CUDA cores, 512 on the tensor cores) adds a
    second launch."""
    Rh = plan.n_half
    if B >= MMA_MIN_BATCH:
        if not transpose:
            return LaunchConfig(True, 1, 256, -(-Rh // 32), 8, 8)
        k = 1 if Rh <= 256 else 2
        threads = min(256, 32 * -(-Rh // (32 * k)))
        return LaunchConfig(True, k, threads, -(-Rh // (k * threads)), 0, 8)
    if transpose:
        k = 2 if Rh <= 256 or (B == 1 and Rh <= 512) else 4
    else:
        k = 4 if B == 1 or 256 < Rh <= 512 else 2
    threads = min(256, 32 * -(-Rh // (32 * k)))
    return LaunchConfig(False, k, threads, -(-Rh // (threads * k)), 0,
                        1 if B == 1 else 2 if B == 2 else 4)


def alm_size(lmax: int, mmax: int) -> int:
    """The length of the packed real-alm vector."""
    return (lmax + 1) ** 2 - (lmax - mmax) * (lmax - mmax + 1)


def column_pairs(mmax: int) -> np.ndarray:
    """The columns a block of K5 or K6 walks, ``(mmax // 2 + 1, 2)`` int32:
    row p is (p, mmax - p), or (p, -1) for the middle column of an even
    mmax, so every block walks 2 lmax - mmax + 2 values of l (the middle
    one half as many)."""
    p = np.arange(mmax // 2 + 1)
    return np.stack([p, np.where(mmax - p != p, mmax - p, -1)], axis=1).astype(np.int32)


def real_alm_index_maps(lmax: int, mmax: int):
    """Gather maps from the packed real-alm vector to dense (lmax+1, mmax+1)
    matrices of cosine (re) and sine (im) coefficients, and their masks."""
    idx_re = np.zeros((lmax + 1, mmax + 1), dtype=np.int64)
    idx_im = np.zeros((lmax + 1, mmax + 1), dtype=np.int64)
    msk_re = np.zeros((lmax + 1, mmax + 1), dtype=np.float64)
    msk_im = np.zeros((lmax + 1, mmax + 1), dtype=np.float64)
    idx_re[:, 0] = np.arange(lmax + 1)
    msk_re[:, 0] = 1.0
    off = lmax + 1
    for m in range(1, mmax + 1):
        for l in range(m, lmax + 1):
            idx_re[l, m], idx_im[l, m] = off, off + 1
            msk_re[l, m] = msk_im[l, m] = 1.0
            off += 2
    return idx_re, msk_re, idx_im, msk_im


def recurrence_tables(lmax: int, mmax: int):
    """The recurrence's coefficients ``a``, ``b`` ((lmax+2, mmax+1), zero
    where l ≤ m) and the diagonal factors ``dfac`` (``dfac[k-1]`` for
    λ_{k,k} = dfac · sin θ · λ_{k-1,k-1})."""
    ls = np.arange(lmax + 2, dtype=np.float64)[:, None]
    ms = np.arange(mmax + 1, dtype=np.float64)[None, :]
    valid = ls >= ms + 1
    with np.errstate(divide="ignore", invalid="ignore"):
        a = np.sqrt((4 * ls**2 - 1.0) / (ls**2 - ms**2))
        b = a * np.sqrt(((ls - 1.0) ** 2 - ms**2) / (4.0 * (ls - 1.0) ** 2 - 1.0))
    a = np.where(valid, a, 0.0)
    b = np.where(valid, np.nan_to_num(b), 0.0)
    m1 = np.arange(1, lmax + 2, dtype=np.float64)
    return a, b, -np.sqrt((2.0 * m1 + 1.0) / (2.0 * m1))


class LegendrePlan(Float64Tables):
    """The tables of the Legendre contraction on one ring grid: ``cos_theta``
    (R,) north to south, north/south symmetric (θ_{R-1-r} = π - θ_r), with
    ``lmax`` and ``mmax``.  Buffers: ``cos_half`` (Rh,), ``seed``
    (mmax+1, Rh) = λ_{m,m}(θ_r), ``ab`` (mmax+1, lmax+1, 2) = (a_{l,m},
    b_{l,m}), all float64 whatever ``.to`` is given; ``col_offset``
    (mmax+1,) int32, where column m starts in the packed alm; ``pairs``
    (:func:`column_pairs`); and for the
    plain versions ``unpack_index`` (lmax+1, mmax+1, 2) into the packed
    alm with one zero appended, and ``pack_index`` (size,) into the dense
    (lmax+1, mmax+1, 2) array."""

    def __init__(self, cos_theta, lmax: int, mmax: int):
        super().__init__()
        z = np.asarray(cos_theta, dtype=np.float64)
        if not np.allclose(z, -z[::-1], rtol=0.0, atol=1e-12):
            raise ValueError("the ring grid is not north/south symmetric")
        lmax, mmax = int(lmax), int(mmax)
        if not 0 <= mmax <= lmax:
            raise ValueError(f"need 0 <= mmax <= lmax, got lmax {lmax}, mmax {mmax}")
        self.lmax, self.mmax = lmax, mmax
        self.n_rings = z.size
        self.n_half = (z.size + 1) // 2
        self.size = alm_size(lmax, mmax)
        zh = z[: self.n_half]
        a, b, dfac = recurrence_tables(lmax, mmax)
        st = np.sqrt(1.0 - zh**2)
        diag = np.cumprod(dfac[:mmax, None] * st[None, :], axis=0) / np.sqrt(4.0 * np.pi)
        seed = np.concatenate([np.full((1, zh.size), 1.0 / np.sqrt(4.0 * np.pi)), diag])
        ab = np.stack([a[: lmax + 1].T, b[: lmax + 1].T], axis=-1)
        for k, v in {"cos_half": zh, "seed": seed, "ab": ab}.items():
            self.register_f64(k, v)
        idx_re, msk_re, idx_im, msk_im = real_alm_index_maps(lmax, mmax)
        col = idx_re[np.arange(mmax + 1), np.arange(mmax + 1)]  # where (l = m, m) lies
        self.register_buffer("col_offset", torch.from_numpy(col.astype(np.int32)))
        self.register_buffer("pairs", torch.from_numpy(column_pairs(mmax)))
        zero = self.size  # the appended zero
        unpack = np.stack([np.where(msk_re > 0, idx_re, zero), np.where(msk_im > 0, idx_im, zero)],
                          axis=-1)
        self.register_buffer("unpack_index", torch.from_numpy(unpack))
        pack = np.empty(self.size, dtype=np.int64)
        flat = np.arange(unpack.size).reshape(unpack.shape)
        live = unpack < zero
        pack[unpack[live]] = flat[live]
        self.register_buffer("pack_index", torch.from_numpy(pack))


def _lambda_rows(plan):
    """λ_{l,m}(θ_r) on the northern rings, (Rh, mmax+1) float64, for
    l = 0..lmax in turn (zero where m > l)."""
    ct = plan.cos_half[:, None]
    prev = torch.zeros(plan.n_half, plan.mmax + 1, dtype=torch.float64, device=ct.device)
    cur = torch.zeros_like(prev)
    for l in range(plan.lmax + 1):
        new = plan.ab[:, l, 0] * ct * cur - plan.ab[:, l, 1] * prev
        if l <= plan.mmax:
            new[:, l] = plan.seed[l]
        prev, cur = cur, new
        yield l, cur


def _even(plan, l, device):
    """Whether l + m is even, per column m."""
    return (l + torch.arange(plan.mmax + 1, device=device)) % 2 == 0


def legendre_contract_plain(alm, plan: LegendrePlan):
    """Plain version of K5: ``alm`` (B, size) -> (B, R, mmax+1, 2)."""
    padded = torch.cat([alm, alm.new_zeros(alm.shape[0], 1)], dim=1)
    c = padded[:, plan.unpack_index]  # (B, L, M, 2)
    even = alm.new_zeros((alm.shape[0], plan.n_half, plan.mmax + 1, 2))
    odd = torch.zeros_like(even)
    for l, lam in _lambda_rows(plan):
        term = lam.to(alm.dtype)[None, :, :, None] * c[:, l, None]
        sel = _even(plan, l, alm.device)[None, None, :, None]
        even = even + torch.where(sel, term, 0.0)
        odd = odd + torch.where(sel, 0.0, term)
    south = (even - odd)[:, : plan.n_rings - plan.n_half].flip(1)
    return torch.cat([even + odd, south], dim=1)


def legendre_contract_t_plain(cot, plan: LegendrePlan):
    """Plain version of K6: ``cot`` (B, R, mmax+1, 2) -> (B, size)."""
    B, Rh = cot.shape[0], plan.n_half
    north = cot[:, :Rh]
    south = torch.cat([cot[:, Rh:].flip(1), cot.new_zeros((B, 2 * Rh - plan.n_rings) + cot.shape[2:])],
                      dim=1)
    p, q = north + south, north - south
    rows = []
    for l, lam in _lambda_rows(plan):
        lam = lam.to(cot.dtype)[None, :, :, None]
        sel = _even(plan, l, cot.device)[None, :, None]
        rows.append(torch.where(sel, (lam * p).sum(1), (lam * q).sum(1)))
    dense = torch.stack(rows, dim=1)  # (B, L, M, 2)
    return dense.reshape(B, -1)[:, plan.pack_index]


def _check(t, plan, what, shape_ok):
    native.require_cuda(t, what, torch.float32, shape_ok)
    if plan.seed.device != t.device:
        raise ValueError(f"{what}: plan on {plan.seed.device}, values on {t.device}")


def legendre_contract(alm, plan: LegendrePlan):
    """K5: packed real alm ``(B, size)`` -> ``(B, R, mmax+1, 2)``."""
    if alm.device.type == "cpu":
        return legendre_contract_plain(alm, plan)
    _check(alm, plan, "legendre_contract", alm.ndim == 2 and alm.shape[1] == plan.size)
    B = alm.shape[0]
    cfg = launch_config(plan, B)
    out = torch.empty((B, plan.n_rings, plan.mmax + 1, 2), dtype=alm.dtype, device=alm.device)
    err = native.lib().nt_legendre_contract(
        alm.data_ptr(), plan.ab.data_ptr(), plan.seed.data_ptr(), plan.cos_half.data_ptr(),
        plan.col_offset.data_ptr(), plan.pairs.data_ptr(), out.data_ptr(), B, plan.size,
        plan.lmax, plan.mmax, plan.n_rings, plan.n_half, int(cfg.mma), cfg.rings_per_thread,
        cfg.threads, cfg.n_chunks, native.stream_of(alm))
    native.check(err, "legendre_contract")
    native.launches["legendre_contract"] += 1
    native.batched_launches["legendre_contract"] += B > 1
    return out


def legendre_contract_t(cot, plan: LegendrePlan):
    """K6: ``(B, R, mmax+1, 2)`` cotangent -> packed real alm ``(B, size)``."""
    if cot.device.type == "cpu":
        return legendre_contract_t_plain(cot, plan)
    _check(cot, plan, "legendre_contract_t",
           cot.ndim == 4 and tuple(cot.shape[1:]) == (plan.n_rings, plan.mmax + 1, 2))
    B = cot.shape[0]
    cfg = launch_config(plan, B, transpose=True)
    out = torch.empty((B, plan.size), dtype=cot.dtype, device=cot.device)
    partial = out if cfg.n_chunks == 1 else torch.empty(
        (cfg.n_chunks, B, plan.size), dtype=cot.dtype, device=cot.device)
    err = native.lib().nt_legendre_contract_t(
        cot.data_ptr(), plan.ab.data_ptr(), plan.seed.data_ptr(), plan.cos_half.data_ptr(),
        plan.col_offset.data_ptr(), plan.pairs.data_ptr(), partial.data_ptr(), out.data_ptr(), B,
        plan.size, plan.lmax, plan.mmax, plan.n_rings, plan.n_half, int(cfg.mma),
        cfg.rings_per_thread, cfg.threads, cfg.n_chunks, native.stream_of(cot))
    native.check(err, "legendre_contract_t")
    native.launches["legendre_contract_t"] += 1
    native.batched_launches["legendre_contract_t"] += B > 1
    return out
