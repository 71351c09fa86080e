"""K7: counter-based standard-normal draws (Philox-4x32-10, Box-Muller).

Entry ``e`` of leaf ``leaf`` of the draw with integer ``seed`` is a
function of ``(seed, leaf, e)`` alone, ``e`` the entry's flat index in the
whole leaf: a rank that holds rows ``[lo, lo + b)`` of a leaf of rows of
``m`` entries draws the entries ``[lo m, (lo + b) m)`` and gets, bit for
bit, those of the one-process draw, without making the rest
(:func:`~..evi.white_noise` of a row-sharded run).  Philox's key is the
seed's two 32-bit halves, its counter ``(q mod 2^32, q / 2^32, leaf, 0)``
for the group ``q = e / 4`` of four entries; its four words ``w`` give the
group's normals by Box-Muller on the pairs ``(w0, w1)`` and ``(w2, w3)``:
``u = (w + 1/2) 2^-32``, ``r = sqrt(-2 log u_a)``, ``(r cos 2πu_b, r sin
2πu_b)``.

:func:`philox_normal` launches K7 (``csrc/normal.cu``) on the card; for a
CPU device it runs the plain version, :func:`philox_normal_plain`: PyTorch
arithmetic on ``int64`` tensors masked to 32 bits (the 32-bit products
split into 16-bit halves, so no product leaves 63 bits), the Box-Muller in
float64, rounded once to the dtype.  The card's f32 normals are computed
in f32 (``logf``, ``sincospif``), so they agree with the plain version to
f32 rounding, not bit for bit; the words agree bit for bit
(:func:`philox_words`).  K7 replaces no Pallas kernel: its counterpart is
the JAX package's shard-local threefry draw, which XLA compiles.
"""

from __future__ import annotations

import math

import torch

from .. import native

__all__ = ["philox_normal", "philox_normal_plain", "philox_words", "philox_words_plain"]

_MASK = 0xFFFFFFFF
_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_MODES = {torch.float32: 0, torch.float64: 1}


def _mulhilo(m: int, c):
    """``(hi, lo)``: the high and low 32 bits of ``m c`` for a 32-bit
    constant ``m`` and int64 ``c`` in ``[0, 2^32)``."""
    a = (m & 0xFFFF) * c  # < 2^48
    b = (m >> 16) * c  # < 2^48
    low = a + ((b & 0xFFFF) << 16)  # < 2^49
    return (b >> 16) + (low >> 32), low & _MASK


def _split(seed: int, leaf: int):
    seed = int(seed) & 0xFFFFFFFFFFFFFFFF
    if not 0 <= int(leaf) <= _MASK:
        raise ValueError(f"leaf index {leaf} outside [0, 2^32)")
    return seed & _MASK, seed >> 32, int(leaf)


def _groups(start: int, n: int, device):
    """The groups of four entries that cover ``[start, start + n)``."""
    return torch.arange(start // 4, (start + n + 3) // 4, dtype=torch.int64, device=device)


def _philox(seed: int, leaf: int, q):
    """The four Philox-4x32-10 words of each group counter in ``q`` (int64),
    ``(len(q), 4)`` int64 in ``[0, 2^32)``."""
    k0, k1, leaf = _split(seed, leaf)
    c0, c1 = q & _MASK, q >> 32
    c2, c3 = torch.full_like(q, leaf), torch.zeros_like(q)
    for _ in range(10):
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0, k1 = (k0 + _W0) & _MASK, (k1 + _W1) & _MASK
    return torch.stack([c0, c1, c2, c3], dim=-1)


def _cut(groups, start: int, n: int):
    """Entries ``[start, start + n)`` of the flattened groups."""
    return groups.reshape(-1)[start % 4 : start % 4 + n]


def philox_normal_plain(seed: int, leaf: int, start: int, n: int, dtype=torch.float32,
                        device="cpu"):
    """Plain version of K7: entries ``[start, start + n)`` of the draw."""
    w = _philox(seed, leaf, _groups(start, n, device)).to(torch.float64)
    u = (w + 0.5) * 2.0**-32
    r = torch.sqrt(-2.0 * torch.log(u[:, 0::2]))  # (groups, 2): the pairs' radii
    theta = (2.0 * math.pi) * u[:, 1::2]
    z = torch.stack([r * torch.cos(theta), r * torch.sin(theta)], dim=-1)  # (groups, 2, 2)
    return _cut(z, start, n).to(dtype)


def _launch(out, n, start, seed, leaf, mode):
    k0, k1, leaf = _split(seed, leaf)
    native.check(native.lib().nt_philox_normal(out.data_ptr(), n, start, k0, k1, leaf, mode,
                                                native.stream_of(out)), "philox_normal")


def philox_normal(seed: int, leaf: int, start: int, n: int, dtype=torch.float32, device="cpu"):
    """K7: the standard normals ``[start, start + n)`` of leaf ``leaf`` of
    the draw ``seed`` (f32 or f64), on ``device``: the kernel on a card,
    the plain version on the CPU."""
    device = torch.device(device)
    if device.type == "cpu":
        return philox_normal_plain(seed, leaf, start, n, dtype, device)
    if dtype not in _MODES:
        raise TypeError(f"philox_normal: dtype {dtype}; float32 or float64 expected")
    if start < 0 or n < 0:
        raise ValueError(f"philox_normal: range [{start}, {start + n}) is not one of a leaf")
    out = torch.empty(n, dtype=dtype, device=device)
    native.require_cuda(out, "philox_normal", dtype, True)
    _launch(out, n, start, seed, leaf, _MODES[dtype])
    native.launches["philox_normal"] += 1
    return out


def philox_words_plain(seed: int, leaf: int, start: int, n: int, device="cpu"):
    """The Philox words behind the entries ``[start, start + n)`` (entry
    ``e`` takes word ``e mod 4`` of its group), int64 in ``[0, 2^32)``."""
    return _cut(_philox(seed, leaf, _groups(start, n, device)), start, n)


def philox_words(seed: int, leaf: int, start: int, n: int, device="cpu"):
    """:func:`philox_words_plain` by K7's words mode on a card (not a launch
    of the main path, so not counted), the plain version on the CPU."""
    device = torch.device(device)
    if device.type == "cpu":
        return philox_words_plain(seed, leaf, start, n, device)
    out = torch.empty(n, dtype=torch.int32, device=device)
    _launch(out, n, start, seed, leaf, 2)
    return out.to(torch.int64) & _MASK
