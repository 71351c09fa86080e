"""A frozen plain copy of the counter-based normal draw that the MGVI
samples' white noise uses.

Entry ``e`` of leaf ``leaf`` of the draw with integer ``seed``: Philox-4x32-10
keyed by the seed's two 32-bit halves, its counter ``(q mod 2^32, q / 2^32,
leaf, 0)`` for the group ``q = e / 4`` of four entries; the group's four
words ``w`` give its normals by Box-Muller on the pairs ``(w0, w1)`` and
``(w2, w3)``: ``u = (w + 1/2) 2^-32``, ``r = sqrt(-2 log u_a)``, ``(r cos
2πu_b, r sin 2πu_b)``.  Written out here, in int64 arithmetic masked to 32
bits, so that the reference draws the same normals from the same key
without calling the program."""

from __future__ import annotations

import math

import torch

__all__ = ["normal"]

_MASK = 0xFFFFFFFF
_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_BLOCK = 1 << 22  # groups a block


def _mulhilo(m, c):
    a = (m & 0xFFFF) * c
    b = (m >> 16) * c
    low = a + ((b & 0xFFFF) << 16)
    return (b >> 16) + (low >> 32), low & _MASK


def _words(seed, leaf, q):
    seed = int(seed) & 0xFFFFFFFFFFFFFFFF
    k0, k1 = seed & _MASK, seed >> 32
    c0, c1 = q & _MASK, q >> 32
    c2, c3 = torch.full_like(q, int(leaf)), torch.zeros_like(q)
    for _ in range(10):
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0, k1 = (k0 + _W0) & _MASK, (k1 + _W1) & _MASK
    return torch.stack([c0, c1, c2, c3], dim=-1)


def normal(seed, leaf, shape, dtype=torch.float64, device="cpu"):
    """The standard normals of leaf ``leaf`` of the draw ``seed``, the whole
    leaf of ``shape``, in ``dtype`` (computed in float64)."""
    n = math.prod(shape)
    out = torch.empty(n, dtype=dtype, device=device)
    groups = (n + 3) // 4
    for g0 in range(0, groups, _BLOCK):
        q = torch.arange(g0, min(groups, g0 + _BLOCK), dtype=torch.int64, device=device)
        u = (_words(seed, leaf, q).to(torch.float64) + 0.5) * 2.0**-32
        r = torch.sqrt(-2.0 * torch.log(u[:, 0::2]))
        theta = (2.0 * math.pi) * u[:, 1::2]
        z = torch.stack([r * torch.cos(theta), r * torch.sin(theta)], dim=-1).reshape(-1)
        lo = 4 * g0
        out[lo: lo + z.numel()] = z[: n - lo].to(dtype)
    return out.reshape(shape)
