"""HEALPix pixelisation (RING and NEST schemes) on int64 tensors
(counterpart of ``nifty_tpu/ops/jhealpix.py``).

The published algorithms of Górski et al. (2005), written branch-free:
every case formula runs for every pixel and ``torch.where`` picks, so one
call handles pixel arrays of any shape on any device.  Indices are int64
throughout (the JAX package's NEST functions use int32, which caps nside
at 8192); the Morton bit-interleaving spreads 32-bit face coordinates, so
nside may reach 2³⁰.  This module is the port's whole HEALPix library:
the multi-grid charts build their stencils with it, and nothing is
compiled for the host.

Every function takes tensors or anything ``torch.as_tensor`` takes and
returns tensors (int64 indices, float64 angles).
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "ang2pix_ring",
    "hpd2nest",
    "hpd2ring",
    "neighbors",
    "nest2hpd",
    "nest2ring",
    "npix",
    "pix2ang_ring",
    "ring2hpd",
    "ring2nest",
]

_I = torch.int64

# face geometry: each base face's ring origin (JRLL) and φ origin (JPLL)
_JRLL = np.array([2, 2, 2, 2, 3, 3, 3, 3, 4, 4, 4, 4])
_JPLL = np.array([1, 3, 5, 7, 0, 2, 4, 6, 1, 3, 5, 7])

# the 8 neighbour offsets (W, NW, N, NE, E, SE, S, SW) and the face
# adjacency for offsets that leave the face (9 sectors, 4 = same face)
_NB_XOFFSET = np.array([-1, -1, 0, 1, 1, 1, 0, -1])
_NB_YOFFSET = np.array([0, 1, 1, 1, 0, -1, -1, -1])
_NB_FACEARRAY = np.array(
    [
        [8, 9, 10, 11, -1, -1, -1, -1, 10, 11, 8, 9],  # S
        [5, 6, 7, 4, 8, 9, 10, 11, 9, 10, 11, 8],  # SE
        [-1, -1, -1, -1, 5, 6, 7, 4, -1, -1, -1, -1],  # E
        [4, 5, 6, 7, 11, 8, 9, 10, 11, 8, 9, 10],  # SW
        [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11],  # center
        [1, 2, 3, 0, 0, 1, 2, 3, 5, 6, 7, 4],  # NE
        [-1, -1, -1, -1, 7, 4, 5, 6, -1, -1, -1, -1],  # W
        [3, 0, 1, 2, 3, 0, 1, 2, 4, 5, 6, 7],  # NW
        [2, 3, 0, 1, -1, -1, -1, -1, 0, 1, 2, 3],  # N
    ]
)
_NB_SWAPARRAY = np.array(
    [[0, 0, 3], [0, 0, 6], [0, 0, 0], [0, 0, 5], [0, 0, 0], [5, 0, 0], [0, 0, 0], [6, 0, 0],
     [3, 0, 0]]
)


def npix(nside: int) -> int:
    return 12 * int(nside) ** 2


def _int(x):
    return torch.as_tensor(x, dtype=_I)


def _table(a, like):
    return torch.as_tensor(a, dtype=_I, device=like.device)


def _floordiv(a, b):
    return torch.div(a, b, rounding_mode="floor")


def ang2pix_ring(nside: int, z, phi):
    """(z = cos θ, φ) -> RING pixel index."""
    nside = int(nside)
    z = torch.as_tensor(z, dtype=torch.float64)
    phi = torch.as_tensor(phi, dtype=torch.float64, device=z.device)
    za = z.abs()
    tt = torch.remainder(phi / (0.5 * np.pi), 4.0)

    # equatorial belt
    t1 = nside * (0.5 + tt)
    t2 = nside * 0.75 * z
    jp_e = torch.floor(t1 - t2).to(_I)
    jm_e = torch.floor(t1 + t2).to(_I)
    ir_e = nside + 1 + jp_e - jm_e
    kshift = 1 - (ir_e & 1)
    ip_e = torch.remainder(_floordiv(jp_e + jm_e - nside + kshift + 1, 2), 4 * nside)
    pix_e = 2 * nside * (nside - 1) + (ir_e - 1) * 4 * nside + ip_e

    # polar caps
    tp = tt - torch.floor(tt)
    tmp = nside * torch.sqrt(torch.clamp_min(3.0 * (1.0 - za), 0.0))
    jp_c = torch.floor(tp * tmp).to(_I)
    jm_c = torch.floor((1.0 - tp) * tmp).to(_I)
    ir_c = jp_c + jm_c + 1
    ip_c = torch.remainder(torch.floor(tt * ir_c).to(_I), 4 * ir_c)
    pix_n = 2 * ir_c * (ir_c - 1) + ip_c
    pix_s = npix(nside) - 2 * ir_c * (ir_c + 1) + ip_c
    pix_cap = torch.where(z > 0, pix_n, pix_s)
    return torch.where(za <= 2.0 / 3.0, pix_e, pix_cap)


def pix2ang_ring(nside: int, pix):
    """RING pixel index -> (z = cos θ, φ), float64."""
    nside = int(nside)
    pix = _int(pix)
    ncap = 2 * nside * (nside - 1)
    total = npix(nside)
    f64 = torch.float64

    # north cap
    ir_n = (0.5 * (1.0 + torch.sqrt(torch.clamp_min(1.0 + 2.0 * pix.to(f64), 1.0)))).to(_I)
    iphi_n = pix + 1 - 2 * ir_n * (ir_n - 1)
    z_n = 1.0 - ir_n.to(f64) ** 2 / (3.0 * nside**2)
    phi_n = (iphi_n.to(f64) - 0.5) * np.pi / (2.0 * torch.clamp_min(ir_n, 1))

    # equatorial belt
    ip = pix - ncap
    ir_e = _floordiv(ip, 4 * nside) + nside
    iphi_e = torch.remainder(ip, 4 * nside) + 1
    fodd = torch.where(((ir_e + nside) & 1).bool(), 1.0, 0.5).to(f64)
    z_e = (2.0 * nside - ir_e.to(f64)) * 2.0 / (3.0 * nside)
    phi_e = (iphi_e.to(f64) - fodd) * np.pi / (2.0 * nside)

    # south cap
    ip_s = total - pix
    ir_s = (0.5 * (1.0 + torch.sqrt(torch.clamp_min(2.0 * ip_s.to(f64) - 1.0, 1.0)))).to(_I)
    iphi_s = 4 * ir_s + 1 - (ip_s - 2 * ir_s * (ir_s - 1))
    z_s = -1.0 + ir_s.to(f64) ** 2 / (3.0 * nside**2)
    phi_s = (iphi_s.to(f64) - 0.5) * np.pi / (2.0 * torch.clamp_min(ir_s, 1))

    north = pix < ncap
    south = pix >= total - ncap
    z = torch.where(north, z_n, torch.where(south, z_s, z_e))
    phi = torch.where(north, phi_n, torch.where(south, phi_s, phi_e))
    return z, phi


def _spread_bits(v):
    """Interleave zeros between the low 32 bits (Morton encoding)."""
    v = _int(v) & 0xFFFFFFFF
    v = (v | (v << 16)) & 0x0000FFFF0000FFFF
    v = (v | (v << 8)) & 0x00FF00FF00FF00FF
    v = (v | (v << 4)) & 0x0F0F0F0F0F0F0F0F
    v = (v | (v << 2)) & 0x3333333333333333
    return (v | (v << 1)) & 0x5555555555555555


def _compress_bits(v):
    """Inverse of :func:`_spread_bits`: keep the even-position bits."""
    v = _int(v) & 0x5555555555555555
    v = (v | (v >> 1)) & 0x3333333333333333
    v = (v | (v >> 2)) & 0x0F0F0F0F0F0F0F0F
    v = (v | (v >> 4)) & 0x00FF00FF00FF00FF
    v = (v | (v >> 8)) & 0x0000FFFF0000FFFF
    return (v | (v >> 16)) & 0x00000000FFFFFFFF


def _isqrt(v):
    """Exact integer square root (float64 sqrt and a fix-up)."""
    v = torch.clamp_min(_int(v), 0)
    r = torch.floor(torch.sqrt(v.to(torch.float64))).to(_I)
    r = torch.where((r + 1) * (r + 1) <= v, r + 1, r)
    return torch.where(r * r > v, r - 1, r)


def nest2hpd(nside: int, pix):
    """NEST pixel -> (x, y, face) discrete face coordinates."""
    pix = _int(pix)
    npface = int(nside) ** 2
    p2 = pix & (npface - 1)
    return _compress_bits(p2), _compress_bits(p2 >> 1), _floordiv(pix, npface)


def hpd2nest(nside: int, x, y, f):
    return _int(f) * (int(nside) ** 2) + _spread_bits(x) + (_spread_bits(y) << 1)


def ring2hpd(nside: int, pix):
    """RING pixel -> (x, y, face), the three regions evaluated branch-free."""
    nside = int(nside)
    pix = _int(pix)
    ncap = 2 * nside * (nside - 1)
    ntot = 12 * nside * nside
    jrll, jpll = _table(_JRLL, pix), _table(_JPLL, pix)

    # north polar cap
    iring_n = torch.clamp_min((1 + _isqrt(1 + 2 * torch.clamp_max(pix, ncap - 1))) >> 1, 1)
    iphi_n = (pix + 1) - 2 * iring_n * (iring_n - 1)
    face_n = torch.clamp(_floordiv(iphi_n - 1, iring_n), 0, 3)
    irt_n = iring_n - jrll[face_n] * nside + 1
    ipt_n = 2 * iphi_n - jpll[face_n] * iring_n - 1
    ipt_n = torch.where(ipt_n >= 2 * nside, ipt_n - 8 * nside, ipt_n)

    # equatorial belt
    ip = pix - ncap
    iring_e = _floordiv(ip, 4 * nside) + nside
    iphi_e = torch.remainder(ip, 4 * nside) + 1
    kshift = (iring_e + nside) & 1
    ire = iring_e - nside + 1
    irm = 2 * nside + 2 - ire
    ifm = _floordiv(iphi_e - _floordiv(ire, 2) + nside - 1, nside)
    ifp = _floordiv(iphi_e - _floordiv(irm, 2) + nside - 1, nside)
    face_e = torch.where(ifp == ifm, torch.remainder(ifp, 4) + 4,
                         torch.where(ifp < ifm, ifp, ifm + 8))
    face_e = torch.clamp(face_e, 0, 11)
    irt_e = iring_e - jrll[face_e] * nside + 1
    ipt_e = 2 * iphi_e - jpll[face_e] * nside - kshift - 1
    ipt_e = torch.where(ipt_e >= 2 * nside, ipt_e - 8 * nside, ipt_e)

    # south polar cap
    ip_s = ntot - pix
    iring_s = torch.clamp_min((1 + _isqrt(2 * torch.clamp_min(ip_s, 1) - 1)) >> 1, 1)
    iphi_s = 4 * iring_s + 1 - (ip_s - 2 * iring_s * (iring_s - 1))
    face_s = torch.clamp(8 + _floordiv(iphi_s - 1, iring_s), 8, 11)
    irt_s = 4 * nside - iring_s - jrll[face_s] * nside + 1
    ipt_s = 2 * iphi_s - jpll[face_s] * iring_s - 1
    ipt_s = torch.where(ipt_s >= 2 * nside, ipt_s - 8 * nside, ipt_s)

    north = pix < ncap
    south = pix >= ntot - ncap
    irt = torch.where(north, irt_n, torch.where(south, irt_s, irt_e))
    ipt = torch.where(north, ipt_n, torch.where(south, ipt_s, ipt_e))
    face = torch.where(north, face_n, torch.where(south, face_s, face_e))
    return (ipt - irt) >> 1, (-(ipt + irt)) >> 1, face


def hpd2ring(nside: int, x, y, f):
    """(x, y, face) -> RING pixel, branch-free over the three regions."""
    nside = int(nside)
    x, y, f = _int(x), _int(y), _int(f)
    jrll, jpll = _table(_JRLL, f), _table(_JPLL, f)
    nl4 = 4 * nside
    jr = jrll[f] * nside - x - y - 1

    def bound(v):
        v = torch.where(v < 1, v + nl4, v)
        return torch.where(v > nl4, v - nl4, v)

    # north cap (jr < nside)
    jp_n = bound(_floordiv(jpll[f] * jr + x - y + 1, 2))
    pix_n = 2 * jr * (jr - 1) + jp_n - 1
    # south cap (jr > 3 nside)
    jri = nl4 - jr
    jp_s = bound(_floordiv(jpll[f] * jri + x - y + 1, 2))
    pix_s = 12 * nside * nside - 2 * (jri + 1) * jri + jp_s - 1
    # equatorial belt
    jp_e = bound(_floordiv(jpll[f] * nside + x - y + 1 + ((jr - nside) & 1), 2))
    pix_e = 2 * nside * (nside - 1) + (jr - nside) * nl4 + jp_e - 1
    return torch.where(jr < nside, pix_n, torch.where(jr > 3 * nside, pix_s, pix_e))


def _require_nest(nside):
    if nside & (nside - 1):
        raise ValueError("NEST requires a power-of-two nside")


def nest2ring(nside: int, pix):
    """NEST -> RING pixel index."""
    _require_nest(int(nside))
    return hpd2ring(nside, *nest2hpd(nside, pix))


def ring2nest(nside: int, pix):
    """RING -> NEST pixel index."""
    _require_nest(int(nside))
    return hpd2nest(nside, *ring2hpd(nside, pix))


def neighbors(nside: int, pix, nest: bool = False):
    """The 8 neighbours of each pixel (W, NW, N, NE, E, SE, S, SW), shape
    ``(..., 8)``; -1 marks the missing neighbour at the 8 face-corner
    singularities."""
    nside = int(nside)
    if nest:
        _require_nest(nside)
    pix = _int(pix)
    x, y, f = nest2hpd(nside, pix) if nest else ring2hpd(nside, pix)
    to_pix = hpd2nest if nest else hpd2ring

    xx = x[..., None] + _table(_NB_XOFFSET, pix)
    yy = y[..., None] + _table(_NB_YOFFSET, pix)
    # which of the 9 adjacency sectors the offset lands in (4: the same face)
    cx = 2 * (xx < 0).to(_I) + (xx >= nside).to(_I)  # 0 inside, 1 over, 2 under
    cy = 2 * (yy < 0).to(_I) + (yy >= nside).to(_I)
    xx_b = torch.where(cx == 1, xx - nside, torch.where(cx == 2, xx + nside, xx))
    yy_b = torch.where(cy == 1, yy - nside, torch.where(cy == 2, yy + nside, yy))
    step = lambda c: torch.where(c == 1, 1, torch.where(c == 2, -1, 0))  # noqa: E731
    nbnum = 4 + step(cx) + 3 * step(cy)
    fnew = _table(_NB_FACEARRAY, pix)[nbnum, f[..., None]]
    bits = _table(_NB_SWAPARRAY, pix)[nbnum, f[..., None] >> 2]
    xs = torch.where((bits & 1).bool(), nside - xx_b - 1, xx_b)
    ys = torch.where((bits & 2).bool(), nside - yy_b - 1, yy_b)
    swap = (bits & 4).bool()
    cross = to_pix(nside, torch.where(swap, ys, xs), torch.where(swap, xs, ys),
                   torch.clamp_min(fnew, 0))
    interior = to_pix(nside, torch.clamp(xx, 0, nside - 1), torch.clamp(yy, 0, nside - 1),
                      f[..., None])
    inside = (cx == 0) & (cy == 0)
    return torch.where(inside, interior, torch.where(fnew >= 0, cross, -1))
