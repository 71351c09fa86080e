"""Port parity: the large-field surface against the JAX package, on the CPU
in float64.  The type-2 NUFFT and SKI's interpolation of a row-sharded
field (``parallel/nufft.py``, ``ski.GridInterpolation``), the
counter-based white-noise draw (K7's plain version,
``ops/cuda_normal.py``) and the large-field VI step
(``tests/test_large_field.py:_run_step``, ``bench.workload.large_field_step``).

(a) Without processes: the sharded NUFFT's stages composed over p = 1, 2,
4 and 8 virtual ranks against ``nifty_tpu.ops.nufft.nufft2`` and
``nufft_adjoint`` of the whole image, real and complex, 2-D and 3-D, with
points whose taps cross the column seam between the last rank and the
first, points on the ranks' column boundaries, and a point on a bin.
(b) One launch of 2 gloo ranks and one of 4 (the worker below, as in
``test_torch_parallel_rest.py``): the metric and energy of a NUFFT and of
a SKI-interpolation likelihood, and one MGVI iteration with
``position_sharding=`` over each (the JAX package's draws) against the JAX
package's ``position_sharding=`` runs on the conftest's 8-device mesh,
each in a process of its own beside them.  On the same launches: the
NUFFT with learned coordinates (``VariablePositionNufft``, 49 points that
split unevenly; metric, energy and the coordinates' cotangent) and
``ShiftedPositionFFT`` (its shifts' rows split with the field's), points
that do not split over the ranks, against the JAX package; one MGVI
iteration over the learned coordinates with a ``kl_reduce`` of one's own
on the field mesh, on a mesh with samples across ranks (2 × 1 and 2 ×
2) and, on 4 ranks, on two (1, 2) meshes over ranks {0, 1} and {2, 3}
side by side with ``odir=`` (the second one resumed), against the JAX
package's ``position_sharding=`` run; the dynamics light cone on a
row-split latent against the JAX package's unsharded one.  (c) K7's plain
version: ranges of a draw against the whole draw, bit for bit, its
moments and a KS statistic; a p-rank ``white_noise`` against the
one-process one.  (d) The large-field step at ``_run_step``'s two smoke
sizes on 2 ranks against the one-process port step.  (e) The refusal that
stays.

Tolerances, and why: the stages 1e-12 of the maximum (float64 FFTs and
sums in another order); the sharded metric and energy 1e-10 (as the
field's metric in ``test_torch_parallel.py``); one MGVI iteration against
the JAX package 1e-4 (the reference's own bound, ``tests/test_parallel.py``);
the light cone 1e-10 relative (one FFT in another order); the
large-field step 1e-5 relative L2 in float32 (the reductions of a
sharded run add in another order); K7's ranges exact; its moments within
5 standard errors at 10⁶ entries, the KS statistic below the 1e-3 level's
1.95/√n.
"""

import functools
import gc
import json
import os
import subprocess
import sys
import weakref

import jax
import numpy as np
import pytest
import torch
from jax import numpy as jnp
from jax import random

import nifty_tpu as nj
import nifty_tpu_torch as nt
from nifty_tpu.ops import nufft as jnufft
from nifty_tpu.utils.tree import random_like as jax_random_like
from nifty_tpu_torch.bench.workload import large_field_step
from nifty_tpu_torch.evi import white_noise
from nifty_tpu_torch.ops.cuda_normal import philox_normal, philox_words, philox_words_plain
from nifty_tpu_torch.parallel import collectives
from nifty_tpu_torch.parallel import nufft as pnufft
from nifty_tpu_torch.parallel.nufft import nufft_stages, taps_cut
from nifty_tpu_torch.utils.tree import get_map

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = dict(device="cpu", dtype=torch.float64)
SHAPE = (32, 32)
N_POINTS = 48  # splits over 2, 4 and 8 ranks
NOISE = 0.05
# one MGVI iteration with CG and Newton-CG cut to a few steps: 48 visibilities of a
# 32² field leave the KL's minimum so flat that ten Newton steps to xtol 1e-8 part
# the one-process port from the JAX package by 0.5 (rounding amplified), sharded or not
CG = dict(maxiter=5, miniter=5, resnorm=-1.0)
KL = dict(maxiter=2, xtol=-1.0, cg_kwargs=CG)
WIDTH = 4  # the NUFFT's kernel width on the ranks: the JAX package's position_sharding=
# run compiles its taps in 95 s at width 6, 63 s at width 4 on the CPU
LEARNED_WIDTH = 2  # the learned coordinates' and the shifts' width: the JAX package compiles
# their derivatives in 46 s (metric, gradient) and its learned MGVI in 116 s at width 4
SMOKE = (((1024, 512), 16), ((128, 64, 16), 8))  # _run_step's CI sizes and knots
WHITE_KEY = 2**40 + 17
N_LEARNED = 49  # learned coordinates: 25 + 24 points over 2 ranks, 13 + 12 + 12 + 12 over 4
UV = 0.01  # the learned coordinates: base + UV · uv
KL_WEIGHTS = [0.4, 0.1, 0.3, 0.2]  # a kl_reduce of one's own: the weights of the 4 samples
CONE = dict(shape=(14, 32), distances=(1.0, 0.5), key="dyn", lightcone_key="lc", sm_s0=1.0,
            sm_x0=(2.0, 2.0), sigc=1.0, quant=2.0, harmonic_padding=(2, 4))  # 16 x 36 latent rows


def _close(got, want, atol=1e-12):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0, atol=atol * max(np.nanmax(np.abs(want)), 1.0))


def _coords(shape, n=N_POINTS, seed=3):
    """Uniform frequencies, and at the front: axis-1 frequencies near 0,
    whose taps (indices -2 .. 3 mod n_os1) cross the column seam between
    the last rank's block and the first's; near ±1/2 (the 2-rank boundary
    at n_os1/2) and ±1/4 (the 4-rank boundaries); and a point on a bin of
    axis 0 (a tap at the window's edge)."""
    rng = np.random.default_rng(seed)
    c = rng.uniform(-0.5, 0.5, (len(shape), n))
    c[1, :7] = [0.0, 0.01, -0.02, 0.4999, -0.5, 0.25, -0.25]
    c[0, 7] = 3.0 / (2 * shape[0])
    return c


# --- (a) the stages over virtual ranks ------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _jax_nufft(shape, kind, width):
    """An image, the coordinates, a cotangent and the JAX package's
    ``nufft2`` and ``nufft_adjoint`` at kernel width ``width`` (once for
    every p)."""
    rng = np.random.default_rng(len(shape))
    x = rng.standard_normal(shape) + (1j * rng.standard_normal(shape) if kind == "complex" else 0)
    coords = _coords(shape)
    g = rng.standard_normal(N_POINTS) + 1j * rng.standard_normal(N_POINTS)
    want = np.asarray(jnufft.nufft2(jnp.asarray(x), jnp.asarray(coords), kernel_width=width))
    want_t = np.asarray(jnufft.nufft_adjoint(jnp.asarray(g), jnp.asarray(coords), shape,
                                             kernel_width=width))
    return x, coords, g, want, want_t.real if kind == "real" else want_t


# 2-D at the default width 6; 3-D at width 4 (64 taps a point, not 216: the
# reference's eager tap loop dominates the file's time)
@pytest.mark.parametrize("shape, width", [(SHAPE, 6), ((16, 12, 8), 4)])
@pytest.mark.parametrize("kind", ["real", "complex"])
@pytest.mark.parametrize("p", [1, 2, 4, 8])
def test_nufft_stages_match_jax(shape, width, kind, p):
    """The ranks' partial outputs summed, and the joined pull-backs of the
    whole cotangent: ``nufft2`` and ``nufft_adjoint`` (the real part for a
    real image) of the JAX package."""
    x, coords, g, want, want_t = _jax_nufft(shape, kind, width)
    st = nufft_stages(shape, torch.from_numpy(coords), p, kernel_width=width)
    b = shape[0] // p
    xt, gt = torch.from_numpy(x), torch.from_numpy(g)[None]
    sent = [st.rows(xt[None, r * b:(r + 1) * b], r) for r in range(p)]
    parts = [st.cols([sent[r][s] for r in range(p)], s) for s in range(p)]
    back = [st.cols_t(gt, s) for s in range(p)]
    pull = torch.cat([st.rows_t([back[s][r] for s in range(p)], r, kind == "real") for r in range(p)],
                     dim=1)[0]
    _close(sum(parts)[0].numpy(), want)
    _close(pull.numpy(), want_t)
    if p > 1:  # a seam point has taps on the last rank's block and the first's
        offs = np.arange(-(width // 2) + 1, width // 2 + 1)
        k1 = (np.floor(coords[1, :3] * st.n_os[1]).astype(int)[:, None] + offs) % st.n_os[1]
        assert ((k1 < st.bounds[1]).any(1) & (k1 >= st.bounds[-2]).any(1)).any()
        assert all(int(t.points.numel()) < N_POINTS for t in st._taps.values())  # cut to the block


# --- (c) K7's plain version ----------------------------------------------------------------------


def test_philox_words_known_answer():
    """Philox-4x32-10 of counter 0 under key 0 (Random123's known answer)."""
    w = philox_words_plain(0, 0, 0, 4)
    assert [int(v) for v in w] == [0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8]


@pytest.mark.parametrize("start, n", [(0, 1), (3, 10), (4, 64), (1021, 1003), (5000, 3)])
def test_philox_ranges_are_the_whole_draws(start, n):
    """Any range drawn alone is that range of the whole draw, bit for bit:
    normals in both dtypes and the words."""
    for dt in (torch.float32, torch.float64):
        whole = philox_normal(2**45 + 3, 7, 0, 6004, dt)
        assert torch.equal(philox_normal(2**45 + 3, 7, start, n, dt), whole[start:start + n])
    assert torch.equal(philox_words(9, 2, start, n), philox_words(9, 2, 0, 6004)[start:start + n])


def test_philox_normals_moments_and_ks():
    """10⁶ entries: mean, variance, skewness and kurtosis within 5 standard
    errors of the standard normal's, the KS statistic below 1.95/√n, and
    other leaves and seeds uncorrelated."""
    from scipy import stats

    n = 10**6
    z = philox_normal(11, 0, 0, n, torch.float64).numpy()
    se = 1.0 / np.sqrt(n)
    assert abs(z.mean()) < 5 * se
    assert abs(z.var() - 1.0) < 5 * np.sqrt(2.0) * se
    assert abs(stats.skew(z)) < 5 * np.sqrt(6.0) * se
    assert abs(stats.kurtosis(z)) < 5 * np.sqrt(24.0) * se
    assert stats.kstest(z, "norm").statistic < 1.95 * se
    for other in (philox_normal(11, 1, 0, n, torch.float64), philox_normal(12, 0, 0, n, torch.float64)):
        assert abs(np.corrcoef(z, other.numpy())[0, 1]) < 5 * se


def _k7_f32_model(a, b):
    """A numpy model of K7's float32 Box-Muller (``csrc/normal.cu`` notes 2
    and 3) of the word pairs ``(a, b)`` (uint32 arrays): every f32 operation
    rounded as the kernel rounds it (an FMA as one rounding of the exact
    result), MUFU's reciprocal square root as the correctly rounded one."""
    f32, f64 = np.float32, np.float64
    fma = lambda x, y, z: (np.asarray(x, f64) * np.asarray(y, f64) + np.asarray(z, f64)).astype(f32)  # noqa: E731
    upper = a >= 0x80000000
    u = fma(a.astype(f32), 2.0**-32, 2.0**-33)
    v = fma((~a).astype(f32), 2.0**-32, 2.0**-33)
    y = np.where(upper, f32(1) - v, u)
    e = (y.view(np.int32) - np.int32(0x3F2AAAAB)) & np.int32(-(1 << 23))
    m = (y.view(np.int32) - e).view(f32)
    t = np.where(upper & (e == 0), -v, m - f32(1))
    q = np.full_like(t, f32(0.14037691056728363))
    for c in (-0.1542675793170929, 0.13994595408439636, -0.16408851742744446, 0.20011146366596222,
              -0.2500821053981781, 0.33333200216293335, -0.4999993145465851):
        q = fma(q, t, f32(c))
    r2 = f32(-2) * fma((e >> 23).astype(f32), f32(0.693147182), fma(t * q, t, t))
    ry = (1.0 / np.sqrt(r2.astype(f64))).astype(f32)
    r0 = r2 * ry
    r = fma(fma(-r0, r0, r2), f32(0.5) * ry, r0)
    q = ((b.astype(np.int64) + 0x20000000) % 2**32) >> 30
    f = (b.astype(np.int64) - (q << 30)) % 2**32
    f = np.where(f >= 2**31, f - 2**32, f)
    x = fma(f.astype(f32), f32(float.fromhex("0x1.921fb6p-30")), f32(float.fromhex("0x1.921fb6p-31")))
    z = x * x
    sn = fma(z * fma(fma(f32(-1.9515295891e-4), z, f32(8.3321608736e-3)), z, f32(-1.6666654611e-1)), x, x)
    pc = fma(fma(f32(2.443315711809948e-5), z, f32(-1.388731625493765e-3)), z, f32(4.166664568298827e-2))
    cs = fma(pc * z, z, fma(f32(-0.5), z, f32(1)))
    S, C = np.where(q & 1, cs, sn), np.where(q & 1, sn, cs)
    return r * np.where((q + 1) & 2, -C, C), r * np.where(q & 2, -S, S)


def test_philox_f32_arithmetic_model_holds_the_tolerance():
    """K7's float32 design, modelled in numpy on 2^20 draws and on the words'
    extremes (u at 2^-33, either side of 1/2 and at 1 - 2^-33; angles on the
    quarter turns): within 1e-6 of the maximum of the plain float64
    Box-Muller, the card's gate, with room (the design's error is ~2e-7)."""
    n = 1 << 20
    w = philox_words_plain(2**50 + 9, 4, 0, n).numpy().astype(np.uint32).reshape(-1, 4)
    z = np.stack(_k7_f32_model(w[:, 0], w[:, 1]) + _k7_f32_model(w[:, 2], w[:, 3]), -1).reshape(-1)
    ref = philox_normal(2**50 + 9, 4, 0, n, torch.float64).numpy()
    assert np.abs(z - ref).max() <= 3e-7 * np.abs(ref).max()
    a = np.array([0, 1, 2**31 - 1, 2**31, 2**32 - 2**20, 2**32 - 2, 2**32 - 1], np.uint32)
    b = np.array([0, 2**29 - 1, 2**29, 2**30, 3 * 2**30, 2**32 - 2**29, 2**32 - 1], np.uint32)
    ua, ub = (a + 0.5) * 2.0**-32, (b + 0.5) * 2.0**-32
    r = np.sqrt(-2.0 * np.log(ua))
    z0, z1 = _k7_f32_model(a, b)
    assert np.abs(z0 - r * np.cos(2 * np.pi * ub)).max() <= 1e-6 * r.max()
    assert np.abs(z1 - r * np.sin(2 * np.pi * ub)).max() <= 1e-6 * r.max()


def test_white_noise_complex_leaves_and_replay():
    """A complex data leaf: real and imaginary parts of variance ½ each; the
    same key replays the same draws, another key others."""
    lh = nt.Gaussian(torch.zeros(40000, dtype=torch.complex128)).amend(lambda x: x["a"] + 0j)
    pos = {"a": torch.zeros(40000, dtype=torch.float64)}
    w = white_noise(lh, pos, 5)
    assert w.data.dtype == torch.complex128 and w.prior["a"].dtype == torch.float64
    assert abs(float(w.data.real.var()) - 0.5) < 0.02 and abs(float(w.data.imag.var()) - 0.5) < 0.02
    again = white_noise(lh, pos, 5)
    assert torch.equal(again.data, w.data) and torch.equal(again.prior["a"], w.prior["a"])
    assert not torch.equal(white_noise(lh, pos, 6).prior["a"], w.prior["a"])


def test_row_blocks_are_cut_once_and_sum_to_the_whole():
    """``RowBlocks``, the row ranges of a grid's sparse matrix that the LOS
    and SKI's interpolation share: the blocks' partial products add up to
    the whole matrix's, their transposes are the whole's cut to the rows,
    and each block is cut once."""
    from nifty_tpu_torch.ops.gather_reduce import PaddedSparse, RowBlocks, transpose_tables

    rng = np.random.default_rng(3)
    grid = (8, 6)
    idx = rng.integers(0, 48, (10, 4))
    wgt = rng.standard_normal((10, 4))
    t_tables = transpose_tables(idx, wgt)
    whole = PaddedSparse(idx, wgt, 48, transpose=t_tables, **CPU)
    blocks = RowBlocks(idx, wgt, t_tables, grid)
    x, y = torch.from_numpy(rng.standard_normal(48)), torch.from_numpy(rng.standard_normal(10))
    parts = sum(blocks(lo, 2, whole.wgt) @ x[lo * 6:(lo + 2) * 6] for lo in range(0, 8, 2))
    np.testing.assert_allclose(parts.numpy(), (whole @ x).numpy(), rtol=1e-12, atol=1e-12)
    pulled = torch.cat([blocks(lo, 2, whole.wgt).T @ y for lo in range(0, 8, 2)])
    np.testing.assert_allclose(pulled.numpy(), (whole.T @ y).numpy(), rtol=1e-12, atol=1e-12)
    assert blocks(2, 2, whole.wgt) is blocks(2, 2, whole.wgt) and len(blocks) == 4


def test_row_shard_knows_the_raveled_rows(monkeypatch):
    """``collectives.row_shard``: the field's noted rows, or with a grid
    shape those rows raveled (SKI's ``W @ cf(x).reshape(-1)``); nothing
    else, and nothing outside a field context."""
    monkeypatch.setattr(collectives.dist, "get_world_size", lambda group=None: 2)
    assert collectives.row_shard(torch.zeros(24), (8, 6)) is None
    with collectives.field_sharded(object(), ["cfxi"]):
        collectives.note_split(torch.zeros(4, 6), rows=True)
        assert collectives.row_shard(torch.zeros(4, 6)) is not None
        assert collectives.row_shard(torch.zeros(24), (8, 6)) is not None
        assert collectives.row_shard(torch.zeros(24)) is None
        assert collectives.row_shard(torch.zeros(48), (8, 6)) is None  # the whole grid
        assert collectives.row_shard(torch.zeros(24), (8, 3, 2)) is None  # rows never noted
        assert collectives.row_shard(torch.zeros(24), (7, 6)) is None  # rows that do not split


# --- (e) the refusal that stays, and what replaced the others -------------------------------------


def _one_rank(monkeypatch):
    """A group of one: its collectives the identity."""
    monkeypatch.setattr(collectives.dist, "get_world_size", lambda group=None: 1)
    monkeypatch.setattr(collectives.dist, "get_rank", lambda group=None: 0)
    for name in ("_all_reduce", "_reduce_scatter"):
        monkeypatch.setattr(collectives, name, lambda x, *a, **k: x.clone())
    monkeypatch.setattr(collectives, "_all_gather", lambda x, *a, **k: x.clone())
    monkeypatch.setattr(collectives, "all_to_all", lambda chunks, shapes, group: list(chunks))


def test_coordinates_as_inputs_are_refused_on_a_sharded_field(monkeypatch):
    """Inside a field context ``ToeplitzSKI`` still raises, naming
    ROADMAP.md (before any collective).  ``VariablePositionNufft``,
    ``ShiftedPositionFFT`` and ``nufft2`` with coordinates that carry a
    gradient run there now: on one rank (a group of one, its collectives
    the identity) each gives the whole image's result, and the
    coordinates' cotangent is the one-process one."""
    _one_rank(monkeypatch)
    rng = np.random.default_rng(0)
    vp = nt.ops.nufft.VariablePositionNufft((8, 8), 6, kernel_width=4)
    sp = nt.ops.nufft.ShiftedPositionFFT((8, 6), kernel_width=4)
    pts = rng.uniform(0.1, 0.9, (1, 6))
    toe = nt.ToeplitzSKI((8,), [(0.0, 1.0)], pts, kernel=lambda d: torch.exp(-d), **CPU)
    x, x6 = (torch.from_numpy(rng.standard_normal(s)) for s in ((8, 8), (8, 6)))
    coords = torch.from_numpy(rng.uniform(-0.5, 0.5, (2, 6)))
    delta = torch.from_numpy(0.3 * rng.standard_normal((2, 8, 6)))
    calls = {
        "vp": lambda c, d: vp({"nufftcoord": c, "nufftgrid": x}),
        "sp": lambda c, d: sp({"spfftdelta_coord": d, "spfftgrid": x6}),
        "nufft2": lambda c, d: nt.nufft2(x, c, kernel_width=4),
    }
    want = {k: torch.func.vjp(f, coords, delta) for k, f in calls.items()}
    with collectives.field_sharded(object(), ["cfxi"]):
        collectives.note_split(x, rows=True)
        collectives.note_split(x6, rows=True)
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            toe(torch.zeros(6, dtype=torch.float64))
        for k, f in calls.items():
            y, pull = torch.func.vjp(f, coords, delta)
            ct = torch.from_numpy(rng.standard_normal(y.shape) + 1j * rng.standard_normal(y.shape))
            _close(y.numpy(), want[k][0].numpy())
            for got, exp in zip(pull(ct), want[k][1](ct)):
                _close(got.numpy(), exp.numpy())


@pytest.mark.parametrize("map_", ["vmap", "lmap"])
def test_learned_plans_are_kept_for_the_mapped_samples_and_go_with_the_model(monkeypatch, map_):
    """``VariablePositionNufft`` on a row-sharded field (one rank), its
    coordinates differing by sample: one call over 8 samples (by
    ``torch.func.vmap`` or an ``lmap`` loop) cuts each sample's taps once,
    derivatives included; a second pass, as a CG solve's next metric
    apply makes, cuts none and gives the same values.  The plans go with
    the model."""
    _one_rank(monkeypatch)
    rng = np.random.default_rng(3)
    vp = nt.ops.nufft.VariablePositionNufft((8, 8), 6, kernel_width=4)
    x = torch.from_numpy(rng.standard_normal((8, 8)))
    base = torch.from_numpy(rng.uniform(-0.4, 0.4, (2, 6)))
    shifts, tangent = (torch.from_numpy(rng.standard_normal(s)) for s in ((8, 2, 6), (2, 6)))

    def push(d):  # the coordinates carry a gradient: the jvp in them
        return torch.func.jvp(lambda e: vp({"nufftcoord": base + 0.01 * e, "nufftgrid": x}), (d,), (tangent,))

    with collectives.field_sharded(object(), ["cfxi"]):
        collectives.note_split(x, rows=True)
        cut0 = taps_cut()
        first = get_map(map_)(push)(shifts)
        cut1 = taps_cut()
        again = get_map(map_)(push)(shifts)
        cut2 = taps_cut()
    assert (cut1 - cut0, cut2 - cut1) == (8, 0)
    for a, b in zip(first, again):
        assert torch.equal(a, b)
    (cache,) = vp._plans.values()
    assert cache.kept == 8
    gone = weakref.ref(cache)
    del vp, cache, push
    gc.collect()
    assert gone() is None


def test_fixed_coordinates_plan_goes_with_the_coordinates(monkeypatch):
    """``nufft2`` at fixed coordinates on a row-sharded field (one rank)
    cuts their taps once while the coordinate tensor lives, without their
    derivatives, and frees the plan when the tensor goes."""
    _one_rank(monkeypatch)
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((8, 8)))
    coords = torch.from_numpy(rng.uniform(-0.5, 0.5, (2, 6)))
    key = id(coords)
    with collectives.field_sharded(object(), ["cfxi"]):
        collectives.note_split(x, rows=True)
        cut0 = taps_cut()
        y = [nt.nufft2(x, coords, kernel_width=4) for _ in range(2)]
        assert taps_cut() - cut0 == 1
    _close(y[0].numpy(), nt.nufft2(x, coords, kernel_width=4).numpy())
    plan = pnufft._FIXED[key][2]
    assert all(t.dwgt is None for t in plan._taps.values())
    gone = weakref.ref(plan)
    del coords, plan
    gc.collect()
    assert key not in pnufft._FIXED and gone() is None


# --- (b) the ranks: 2 and 4 gloo processes --------------------------------------------------------

WORKER = r'''
import json, os, sys
rank, nproc, store, d, root = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4], sys.argv[5]
sys.path.insert(0, root)
import numpy as np
import torch
torch.set_num_threads(1)
import nifty_tpu_torch as nt
from nifty_tpu_torch import parallel
from nifty_tpu_torch.bench.workload import large_field_step
from nifty_tpu_torch.evi import seeds, white_noise
from nifty_tpu_torch.models.dynamics import dynamic_lightcone_operator
from nifty_tpu_torch.parallel import NamedSharding
from nifty_tpu_torch.parallel.collectives import field_sharded
from torch.distributed.device_mesh import DeviceMesh
from torch.utils._pytree import tree_map

parallel.initialize(store, nproc, rank, device="cpu")
inp = dict(np.load(os.path.join(d, "inputs.npz")))
cfg = json.load(open(os.path.join(d, "config.json")))
f64 = torch.float64
T = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
share = lambda a, p=nproc, r=rank: np.array_split(a, p)[r]  # noqa: E731
tree = lambda prefix: {k[len(prefix):]: inp[k] for k in inp if k.startswith(prefix)}  # noqa: E731
shape = tuple(cfg["shape"])
out = {}
mesh = parallel.global_mesh(("fx",))
cfm = nt.CorrelatedFieldMaker("cf")
cfm.set_amplitude_total_offset(0.5, (1e-1, 3e-2))
cfm.add_fluctuations(shape, 1.0 / shape[0], (1.0, 0.5), (-3.0, 0.2), (1.0, 0.2))
cf = cfm.finalize(device="cpu", dtype=f64, field_mesh=mesh)
# meshes over some of the ranks, each built by every rank in one order
sub = {}
if nproc == 2:
    sub["s2f1"] = DeviceMesh("cpu", torch.tensor([[0], [1]]), mesh_dim_names=("samples", "fx"))
else:
    sub["s2f2"] = DeviceMesh("cpu", torch.tensor([[0, 1], [2, 3]]), mesh_dim_names=("samples", "fx"))
    halves = [DeviceMesh("cpu", torch.tensor([ranks]), mesh_dim_names=("samples", "fx"))
              for ranks in ([0, 1], [2, 3])]
sh = cf.position_sharding()
keys = [k for k, v in sh.items() if v.split_axes()]
coords = T(inp["coords"])
ski = nt.HarmonicSKI(shape, [(0.0, 1.0)] * 2, inp["ski_points"], harmonic_kernel=lambda k: 1.0 / (1.0 + k**2),
                     device="cpu", dtype=f64)
noise = cfg["noise"]
lh_n = nt.Gaussian(T(share(inp["vis"])), noise_cov_inv=lambda r: r / noise**2).amend(
    lambda x: nt.nufft2(torch.exp(cf(x)), coords, kernel_width=cfg["width"]))
lh_s = nt.Gaussian(T(share(inp["ski_data"])), noise_std_inv=lambda r: r / noise).amend(
    lambda x: ski.w @ torch.exp(cf(x)).reshape(-1))

# the metric and energy of both likelihoods inside the field context; the white noise
with field_sharded(mesh.get_group("fx"), keys):
    pos = nt.position_from_numpy(cf, tree("mpos/"), sharding=sh)
    tan = nt.position_from_numpy(cf, tree("mtan/"), sharding=sh)
    for name, lh in (("nufft", lh_n), ("ski", lh_s)):
        out[f"{name}/energy"] = lh(pos).detach().numpy()
        for k, v in lh.metric(pos, tan).items():
            out[f"{name}/metric/{k}"] = v.detach().numpy()
    w = white_noise(lh_n, pos, cfg["white_key"])
    out["white/data"] = w.data.numpy()
    for k, v in w.prior.items():
        out["white/prior/" + k] = v.numpy()

# one MGVI iteration by position_sharding= over each response, the JAX package's draws
order = seeds(torch.Generator().manual_seed(42), 2)
for name, lh in (("nufft", lh_n), ("ski", lh_s)):
    def linear(lh_, pos, seed, name=name, **kw):
        i = order.index(seed)
        prior = {k: T(share(v)) if k == "cfxi" else T(v)
                 for k, v in sorted(tree(f"white{i}/prior/").items())}
        white = nt.WhiteNoise(T(share(inp[f"white{i}/{name}"])), prior)
        return nt.draw_linear_residual(lh_, pos, white=white, **kw)

    opt = nt.OptimizeVI(lh, 1, position_sharding=sh, _draw_linear_residual=linear)
    s, _ = nt.optimize_kl(lh, nt.position_from_numpy(cf, tree("start/"), sharding=sh),
                          key=torch.Generator().manual_seed(42), n_total_iterations=1, n_samples=2,
                          draw_linear_kwargs=dict(cg_kwargs=cfg["cg"]),
                          kl_kwargs=dict(minimize_kwargs=cfg["kl"]), sample_mode="linear_resample",
                          _optimize_vi=opt)
    for k, v in opt.gather(s).pos.items():
        out[f"vi/{name}/{k}"] = v.numpy()

# points that do not split over the ranks: the rank's share of the visibilities and an energy
odd = coords[:, :nproc + 1]
lh_o = nt.Gaussian(T(share(inp["vis"][:nproc + 1])), noise_cov_inv=lambda r: r / noise**2).amend(
    lambda x: nt.nufft2(torch.exp(cf(x)), odd, kernel_width=cfg["width"]))
ski_odd = nt.HarmonicSKI(shape, [(0.0, 1.0)] * 2, inp["ski_points"][:, :nproc + 1],
                         harmonic_kernel=lambda k: 1.0 / (1.0 + k**2), device="cpu", dtype=f64)
with field_sharded(mesh.get_group("fx"), keys):
    out["odd/vis"] = nt.nufft2(torch.exp(cf(pos)), odd, kernel_width=cfg["width"]).numpy()
    out["odd/energy"] = lh_o(pos).detach().numpy()
    w = white_noise(lh_o, pos, cfg["white_key"])  # K7's offsets for shares that differ by a point
    out["odd/white/data"] = w.data.numpy()
    for k, v in w.prior.items():
        out["odd/white/prior/" + k] = v.numpy()
    out["odd/ski"] = (ski_odd.w @ torch.exp(cf(pos)).reshape(-1)).numpy()

# learned coordinates (VariablePositionNufft; 49 points, uneven shares) and ShiftedPositionFFT
base = T(inp["base"])
vp = nt.ops.nufft.VariablePositionNufft(shape, base.shape[1], kernel_width=cfg["learned_width"])
sp = nt.ops.nufft.ShiftedPositionFFT(shape, kernel_width=cfg["learned_width"])


def learned(cf_, fp=nproc, fr=rank):
    return nt.Gaussian(T(share(inp["vis_learned"], fp, fr)), noise_cov_inv=lambda r: r / noise**2).amend(
        lambda x: vp({"nufftgrid": torch.exp(cf_(x)), "nufftcoord": base + cfg["uv"] * x["uv"]}))


lh_sp = nt.Gaussian(T(share(inp["data_sp"])), noise_cov_inv=lambda r: r / noise**2).amend(
    lambda x: sp({"spfftgrid": torch.exp(cf(x)), "spfftdelta_coord": x["spfftdelta_coord"]}))
dc_rows = lambda a: np.split(a, nproc, axis=1)[rank]  # noqa: E731
for name, lh, extra, split in (("learned", learned(cf), "uv", False),
                               ("shifted", lh_sp, "spfftdelta_coord", True)):
    cut = dc_rows if split else (lambda a: a)
    with field_sharded(mesh.get_group("fx"), keys + ([extra] if split else [])):
        p_ = {**pos, extra: T(cut(inp[f"{extra}/mpos"]))}
        t_ = {**tan, extra: T(cut(inp[f"{extra}/mtan"]))}
        out[f"{name}/energy"] = lh(p_).detach().numpy()
        for k, v in lh.metric(p_, t_).items():
            out[f"{name}/metric/{k}"] = v.detach().numpy()
        out[f"{name}/grad"] = torch.func.grad(lh)(p_)[extra].numpy()

# one MGVI iteration over the learned coordinates with a kl_reduce of one's own (weights of the
# 4 samples), the JAX package's draws: on the field mesh, with samples across ranks, and on 4
# ranks on two (1, 2) meshes side by side with odir= (the second resumed after it)
weights = T(cfg["kl_weights"])
kl_reduce = lambda t: tree_map(lambda v: torch.tensordot(weights.to(v.dtype), v, dims=1), t)  # noqa: E731


def learned_vi(m, odir=None, resume=False):
    fax = parallel.fft.mesh_axis(m, "fx")
    cf_ = cfm.finalize(device="cpu", dtype=f64, field_mesh=m)
    sh_ = {**cf_.position_sharding(), "uv": NamedSharding(m, ())}
    lh = learned(cf_, fax.size, fax.rank)

    def linear(lh_, pos_, seed, **kw):
        i = order.index(seed)
        prior = {k: T(share(v, fax.size, fax.rank)) if k == "cfxi" else T(v)
                 for k, v in sorted(tree(f"white{i}/lprior/").items())}
        white = nt.WhiteNoise(T(share(inp[f"white{i}/learned"], fax.size, fax.rank)), prior)
        return nt.draw_linear_residual(lh_, pos_, white=white, **kw)

    opt = nt.OptimizeVI(lh, 1, position_sharding=sh_, kl_reduce=kl_reduce, _draw_linear_residual=linear,
                        _get_status_message=lambda *a, **k: "")
    start = {**nt.position_from_numpy(cf_, tree("start/"), sharding=cf_.position_sharding()),
             "uv": T(inp["uv/start"])}
    s_, st = nt.optimize_kl(lh, start, key=torch.Generator().manual_seed(42), n_total_iterations=1,
                            n_samples=2, draw_linear_kwargs=dict(cg_kwargs=cfg["cg"]),
                            kl_kwargs=dict(minimize_kwargs=cfg["kl"]), sample_mode="linear_resample",
                            odir=odir, resume=resume, _optimize_vi=opt)
    return opt.gather(s_).pos, st


runs = {"fx": mesh, **sub}
if nproc == 4:
    half = rank // 2
    runs[f"half{half}"] = (halves[half], os.path.join(d, f"half{half}"))
for name, run in runs.items():
    m, odir = run if isinstance(run, tuple) else (run, None)
    whole, _ = learned_vi(m, odir)
    out.update({f"vi/learned_{name}/{k}": v.numpy() for k, v in whole.items()})
    if name == "half1":  # the second half resumes its checkpoint alone
        whole, st = learned_vi(m, odir, resume=True)
        out.update({f"vi/learned_resumed/{k}": v.numpy() for k, v in whole.items()})
        out["resumed_nit"] = np.asarray(st.nit)

# the dynamics light cone on a row-split latent
cone, _ = dynamic_lightcone_operator(**cfg["cone"])
with field_sharded(mesh.get_group("fx"), ["dyn"]):
    x_ = {"dyn": T(share(inp["cone/dyn"])), "lc": T(inp["cone/lc"])}
    y, pull = torch.func.vjp(cone, x_)
    out["cone/value"] = y.numpy()
    lo = sum(len(a) for a in np.array_split(np.arange(cfg["cone"]["shape"][0]), nproc)[:rank])
    g = pull(T(inp["cone/cot"][lo:lo + y.shape[0]]))[0]
    out["cone/grad/dyn"], out["cone/grad/lc"] = g["dyn"].numpy(), g["lc"].numpy()

# the large-field step at _run_step's smoke sizes
if nproc == 2:
    for i, (size, knots) in enumerate(cfg["smoke"]):
        cfl, x, e = large_field_step(tuple(size), knots, "cpu", field_mesh=mesh)
        out[f"large{i}/energy"] = np.asarray(e)
        out[f"large{i}/xi_rows"] = np.asarray(cfl.rows)
        for k, v in x.items():
            out[f"large{i}/{k}"] = v.numpy()
np.savez(os.path.join(d, f"out{rank}.npz"), **out)
print("done", rank, flush=True)
'''


def _jax_field(mesh=None):
    cfm = nj.CorrelatedFieldMaker("cf")
    cfm.set_amplitude_total_offset(0.5, (1e-1, 3e-2))
    cfm.add_fluctuations(SHAPE, 1.0 / SHAPE[0], (1.0, 0.5), (-3.0, 0.2), (1.0, 0.2))
    return cfm.finalize() if mesh is None else cfm.finalize(field_mesh=mesh)


def _kernel(k):
    return 1.0 / (1.0 + k**2)


def _jax_lhs(inp, cf):
    """The JAX package's NUFFT and SKI-interpolation likelihoods of exp(cf)."""
    coords = jnp.asarray(inp["coords"])
    ski = nj.HarmonicSKI(SHAPE, [(0.0, 1.0)] * 2, inp["ski_points"], harmonic_kernel=_kernel)
    lh_n = nj.Gaussian(jnp.asarray(inp["vis"]), noise_cov_inv=lambda r: r / NOISE**2).amend(
        lambda x: jnufft.nufft2(jnp.exp(cf(x)), coords, kernel_width=WIDTH))
    lh_s = nj.Gaussian(jnp.asarray(inp["ski_data"]), noise_std_inv=lambda r: r / NOISE).amend(
        lambda x: ski.w @ jnp.exp(cf(x)).reshape(-1))
    return lh_n, lh_s


def _jax_learned(inp, cf):
    """The JAX package's likelihood over ``VariablePositionNufft`` of exp(cf)
    at the coordinates ``base + UV · uv``, ``uv`` a latent."""
    base = jnp.asarray(inp["base"])
    vp = jnufft.VariablePositionNufft(SHAPE, N_LEARNED, kernel_width=LEARNED_WIDTH)
    return nj.Gaussian(jnp.asarray(inp["vis_learned"]), noise_cov_inv=lambda r: r / NOISE**2).amend(
        lambda x: vp({"nufftgrid": jnp.exp(cf(x)), "nufftcoord": base + UV * x["uv"]}))


def _jax_shifted(inp, cf):
    """The JAX package's likelihood over ``ShiftedPositionFFT`` of exp(cf)."""
    sp = jnufft.ShiftedPositionFFT(SHAPE, kernel_width=LEARNED_WIDTH)
    return nj.Gaussian(jnp.asarray(inp["data_sp"]), noise_cov_inv=lambda r: r / NOISE**2).amend(
        lambda x: sp({"spfftgrid": jnp.exp(cf(x)), "spfftdelta_coord": x["spfftdelta_coord"]}))


def _draw(domain, rng, scale=1.0):
    return {k: scale * rng.standard_normal(v.shape) for k, v in sorted(domain.items())}


def _tree(inp, prefix):
    return {k[len(prefix):]: jnp.asarray(v) for k, v in inp.items() if k.startswith(prefix)}


def _inputs():
    rng = np.random.default_rng(17)
    cf = _jax_field()
    inp = {"coords": _coords(SHAPE), "ski_points": rng.uniform(0.02, 0.98, (2, N_POINTS))}
    rho = jax.jit(lambda p: jnp.exp(cf(p)))(cf.init(random.PRNGKey(10)))
    vis = np.asarray(jnufft.nufft2(rho, jnp.asarray(inp["coords"]), kernel_width=WIDTH))
    inp["vis"] = vis + NOISE * (rng.standard_normal(N_POINTS) + 1j * rng.standard_normal(N_POINTS))
    ski = nj.HarmonicSKI(SHAPE, [(0.0, 1.0)] * 2, inp["ski_points"], harmonic_kernel=_kernel)
    inp["ski_data"] = np.asarray(ski.w @ rho.reshape(-1)) + NOISE * rng.standard_normal(N_POINTS)
    for name, scale in (("mpos", 0.3), ("mtan", 1.0), ("start", 0.1)):
        inp.update({f"{name}/{k}": v for k, v in _draw(cf.domain, rng, scale).items()})
    lhs = dict(zip(("nufft", "ski"), _jax_lhs(inp, cf)))
    start = {k[6:]: v for k, v in inp.items() if k.startswith("start/")}
    _, sk = random.split(random.PRNGKey(42), 2)
    for i, k in enumerate(random.split(sk, 2)):  # the keys of the iteration's draws
        k_nll, k_prr = random.split(k, 2)
        for name, lh in lhs.items():
            inp[f"white{i}/{name}"] = np.array(jax_random_like(k_nll, lh.left_sqrt_metric_tangents_shape))
        prior = jax_random_like(k_prr, start)
        for name, v in zip(sorted(start), jax.tree_util.tree_leaves(prior)):
            inp[f"white{i}/prior/{name}"] = np.array(v)
    _learned_inputs(inp, cf, rho)
    return inp


def _learned_inputs(inp, cf, rho):
    """The inputs of the learned coordinates, ``ShiftedPositionFFT``, the
    light cone and the JAX package's draws of the learned MGVI iteration
    (a generator of their own, so the other inputs stay as they were)."""
    rng = np.random.default_rng(19)
    inp["base"] = _coords(SHAPE, N_LEARNED, seed=5)
    uv = rng.standard_normal((2, N_LEARNED))
    vis = np.asarray(jnufft.nufft2(rho, jnp.asarray(inp["base"] + UV * uv), kernel_width=LEARNED_WIDTH))
    inp["vis_learned"] = vis + NOISE * (rng.standard_normal(N_LEARNED) + 1j * rng.standard_normal(N_LEARNED))
    sp = jnufft.ShiftedPositionFFT(SHAPE, kernel_width=LEARNED_WIDTH)
    delta = 0.3 * rng.standard_normal((2,) + SHAPE)
    vis = np.asarray(sp({"spfftgrid": rho, "spfftdelta_coord": jnp.asarray(delta)}))
    inp["data_sp"] = vis + NOISE * (rng.standard_normal(SHAPE) + 1j * rng.standard_normal(SHAPE))
    for name, scale in (("mpos", 0.3), ("mtan", 1.0), ("start", 0.1)):
        inp[f"uv/{name}"] = scale * rng.standard_normal((2, N_LEARNED))
        inp[f"spfftdelta_coord/{name}"] = scale * rng.standard_normal((2,) + SHAPE)
    pshape = tuple(n + p for n, p in zip(CONE["shape"], CONE["harmonic_padding"]))
    inp["cone/dyn"] = rng.standard_normal(pshape)
    inp["cone/lc"] = rng.standard_normal(1)
    inp["cone/cot"] = rng.standard_normal(CONE["shape"]) + 1j * rng.standard_normal(CONE["shape"])
    lh = _jax_learned(inp, cf)
    start = {**{k[6:]: v for k, v in inp.items() if k.startswith("start/")}, "uv": inp["uv/start"]}
    _, sk = random.split(random.PRNGKey(42), 2)
    for i, k in enumerate(random.split(sk, 2)):
        k_nll, k_prr = random.split(k, 2)
        inp[f"white{i}/learned"] = np.array(jax_random_like(k_nll, lh.left_sqrt_metric_tangents_shape))
        prior = jax_random_like(k_prr, start)
        for name, v in zip(sorted(start), jax.tree_util.tree_leaves(prior)):
            inp[f"white{i}/lprior/{name}"] = np.array(v)


def _jax_vi(inp, name):
    """The JAX package's MGVI iteration over the NUFFT (``name`` "nufft"),
    SKI's interpolation ("ski") or the learned coordinates ("learned", a
    ``kl_reduce`` of the samples weighted by ``KL_WEIGHTS``) with
    ``position_sharding=`` on the conftest's 8-device mesh (in a process of
    its own, ``JAX_VI``)."""
    from jax.sharding import Mesh, NamedSharding, PartitionSpec

    mesh = Mesh(np.asarray(jax.devices()), ("fx",))
    cfs = _jax_field(mesh)
    sharding, start, kw = cfs.position_sharding(), _tree(inp, "start/"), {}
    if name == "learned":
        lh = _jax_learned(inp, cfs)
        sharding = {**sharding, "uv": NamedSharding(mesh, PartitionSpec())}
        start["uv"] = jnp.asarray(inp["uv/start"])
        w = jnp.asarray(KL_WEIGHTS)
        kw["kl_reduce"] = lambda t: jax.tree_util.tree_map(lambda v: jnp.tensordot(w, v, axes=1), t)
    else:
        lh = dict(zip(("nufft", "ski"), _jax_lhs(inp, cfs)))[name]
    # no status message: the JAX package's minisanity takes float() of a
    # complex residual's moments
    opt = nj.OptimizeVI(lh, 1, position_sharding=sharding, _get_status_message=lambda *a, **k: "",
                        **kw)
    sj, _ = nj.optimize_kl(lh, start, n_total_iterations=1, n_samples=2,
                           key=random.PRNGKey(42), draw_linear_kwargs=dict(cg_kwargs=CG),
                           kl_kwargs=dict(minimize_kwargs=KL), sample_mode="linear_resample",
                           odir=None, position_sharding=sharding, _optimize_vi=opt)
    return {k: np.asarray(v) for k, v in dict(getattr(sj.pos, "tree", sj.pos)).items()}


JAX_VI = r'''
import os, sys
d, root = sys.argv[1], sys.argv[2]
sys.path[:0] = [os.path.join(root, "tests"), root]
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
import numpy as np
import test_torch_parallel_large as t
name = sys.argv[3]
np.savez(os.path.join(d, f"jax_vi_{name}.npz"),
         **t._jax_vi(dict(np.load(os.path.join(d, "inputs.npz"))), name))
'''


def _wants(inp):
    """The JAX package's metrics and energies of the likelihoods (the
    learned coordinates' and the shifts' cotangents too), the visibilities
    and energies at points that do not split over 2 and 4 ranks, and the
    light cone with its pull-back."""
    want = {}
    cf = _jax_field()
    for name, lh in zip(("nufft", "ski"), _jax_lhs(inp, cf)):
        want[f"{name}/energy"] = np.asarray(jax.jit(lh)(_tree(inp, "mpos/")))
        metric = jax.jit(lh.metric)(_tree(inp, "mpos/"), _tree(inp, "mtan/"))
        want.update({f"{name}/metric/{k}": np.asarray(v) for k, v in dict(metric).items()})
    for name, lh, extra in (("learned", _jax_learned(inp, cf), "uv"),
                            ("shifted", _jax_shifted(inp, cf), "spfftdelta_coord")):
        p_ = {**_tree(inp, "mpos/"), extra: jnp.asarray(inp[f"{extra}/mpos"])}
        t_ = {**_tree(inp, "mtan/"), extra: jnp.asarray(inp[f"{extra}/mtan"])}
        energy, grad, metric = jax.jit(lambda p, t, lh=lh: (lh(p), jax.grad(lh)(p), lh.metric(p, t)))(p_, t_)
        want[f"{name}/energy"], want[f"{name}/grad"] = np.asarray(energy), np.asarray(grad[extra])
        want.update({f"{name}/metric/{k}": np.asarray(v) for k, v in dict(metric).items()})
    rho = jax.jit(lambda p: jnp.exp(cf(p)))(_tree(inp, "mpos/"))
    for p in (2, 4):
        odd = jnp.asarray(inp["coords"][:, :p + 1])
        want[f"odd{p}/vis"] = np.asarray(jnufft.nufft2(rho, odd, kernel_width=WIDTH))
        lh = nj.Gaussian(jnp.asarray(inp["vis"][:p + 1]), noise_cov_inv=lambda r: r / NOISE**2).amend(
            lambda x, odd=odd: jnufft.nufft2(jnp.exp(cf(x)), odd, kernel_width=WIDTH))
        want[f"odd{p}/energy"] = np.asarray(lh(_tree(inp, "mpos/")))
        ski = nj.HarmonicSKI(SHAPE, [(0.0, 1.0)] * 2, inp["ski_points"][:, :p + 1], harmonic_kernel=_kernel)
        want[f"odd{p}/ski"] = np.asarray(ski.w @ rho.reshape(-1))
    from nifty_tpu.models.dynamics import dynamic_lightcone_operator

    cone, _ = dynamic_lightcone_operator(**CONE)
    x = {"dyn": jnp.asarray(inp["cone/dyn"]), "lc": jnp.asarray(inp["cone/lc"])}
    y, pull = jax.vjp(cone, x)
    want["cone/value"] = np.asarray(y)
    g = pull(jnp.conj(jnp.asarray(inp["cone/cot"])).astype(y.dtype))[0]  # torch's vjp conjugates
    want["cone/grad/dyn"], want["cone/grad/lc"] = np.asarray(g["dyn"]), np.asarray(g["lc"])
    return want


def _one_process(inp):
    """The port's one-process white noise and large-field steps."""
    cfm = nt.CorrelatedFieldMaker("cf")
    cfm.set_amplitude_total_offset(0.5, (1e-1, 3e-2))
    cfm.add_fluctuations(SHAPE, 1.0 / SHAPE[0], (1.0, 0.5), (-3.0, 0.2), (1.0, 0.2))
    cf = cfm.finalize(**CPU)
    coords = torch.from_numpy(inp["coords"])
    lh = nt.Gaussian(torch.from_numpy(inp["vis"]), noise_cov_inv=lambda r: r / NOISE**2).amend(
        lambda x: nt.nufft2(torch.exp(cf(x)), coords, kernel_width=WIDTH))
    pos = nt.position_from_numpy(cf, {k[5:]: v for k, v in inp.items() if k.startswith("mpos/")})
    w = white_noise(lh, pos, WHITE_KEY)
    one = {"white/data": w.data.numpy(), **{"white/prior/" + k: v.numpy() for k, v in w.prior.items()}}
    for p in (2, 4):  # the nproc + 1 points of the workers' uneven shares
        lh_o = nt.Gaussian(torch.from_numpy(inp["vis"][:p + 1]), noise_cov_inv=lambda r: r / NOISE**2).amend(
            lambda x, p=p: nt.nufft2(torch.exp(cf(x)), coords[:, :p + 1], kernel_width=WIDTH))
        w = white_noise(lh_o, pos, WHITE_KEY)
        one[f"odd{p}/white/data"] = w.data.numpy()
        one.update({f"odd{p}/white/prior/" + k: v.numpy() for k, v in w.prior.items()})
    for i, (size, knots) in enumerate(SMOKE):
        _, x, e = large_field_step(size, knots, "cpu")
        one[f"large{i}/energy"] = e
        one.update({f"large{i}/{k}": v.numpy() for k, v in x.items()})
    return one


def _start(d, nproc, inp):
    d = str(d)
    np.savez(os.path.join(d, "inputs.npz"), **inp)
    cfg = dict(shape=list(SHAPE), noise=NOISE, cg=CG, kl=KL, white_key=WHITE_KEY, width=WIDTH,
               smoke=[[list(s), k] for s, k in SMOKE], uv=UV, kl_weights=KL_WEIGHTS, cone=CONE,
               learned_width=LEARNED_WIDTH)
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump(cfg, f)
    script = os.path.join(d, "worker.py")
    with open(script, "w") as f:
        f.write(WORKER)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    store = os.path.join(d, "store")
    return d, [subprocess.Popen([sys.executable, script, str(r), str(nproc), store, d, ROOT],
                                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                                env=env) for r in range(nproc)]


def _finish(d, procs, outputs=True):
    logs = []
    try:
        for pr in procs:
            logs.append(pr.communicate(timeout=240)[0])
    finally:
        for pr in procs:
            if pr.poll() is None:
                pr.kill()
    for pr, log in zip(procs, logs):
        assert pr.returncode == 0, log[-4000:]
    if outputs:
        return [dict(np.load(os.path.join(d, f"out{r}.npz"))) for r in range(len(procs))]


@pytest.fixture(scope="module")
def launches(tmp_path_factory):
    """One launch of 2 ranks and one of 4, side by side, with the JAX
    package's ``position_sharding=`` run; the JAX references and the port's
    one-process runs are computed while they run."""
    inp = _inputs()
    started = {n: _start(tmp_path_factory.mktemp(f"ranks{n}"), n, inp) for n in (2, 4)}
    d = str(tmp_path_factory.mktemp("jax_vi"))
    np.savez(os.path.join(d, "inputs.npz"), **inp)
    with open(os.path.join(d, "jax_vi.py"), "w") as f:
        f.write(JAX_VI)
    vis = [subprocess.Popen([sys.executable, os.path.join(d, "jax_vi.py"), d, ROOT, name],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
           for name in ("nufft", "ski", "learned")]
    want = _wants(inp)
    one = _one_process(inp)
    ranks = {n: _finish(*started[n]) for n in (2, 4)}
    _finish(d, vis, outputs=False)
    for name in ("nufft", "ski", "learned"):
        want[f"vi/{name}"] = dict(np.load(os.path.join(d, f"jax_vi_{name}.npz")))
    return ranks, want, one, {n: started[n][0] for n in (2, 4)}


RANKS = pytest.mark.parametrize("nproc", [2, 4])


def _rows(a, rank, p):
    return np.split(a, p)[rank]


@RANKS
@pytest.mark.parametrize("response", ["nufft", "ski"])
def test_sharded_metric_and_energy_match_jax(launches, nproc, response):
    """The metric and energy of a Gaussian over the NUFFT (or SKI's
    interpolation) of exp(cf), the field row-sharded, the data each rank's
    share of the points: the JAX package's (ξ's rows, the rest whole, the
    energy once)."""
    outs, want = launches[0][nproc], launches[1]
    for r, out in enumerate(outs):
        _close(out[f"{response}/energy"], want[f"{response}/energy"], atol=1e-10)
        for k in [k for k in want if k.startswith(f"{response}/metric/")]:
            _close(out[k], _rows(want[k], r, nproc) if k.endswith("cfxi") else want[k], atol=1e-10)


@RANKS
@pytest.mark.parametrize("response", ["nufft", "ski"])
def test_position_sharded_optimize_kl_matches_jax(launches, nproc, response):
    """One MGVI iteration with ``position_sharding=`` over the NUFFT (or SKI's
    interpolation), the JAX package's draws, gathered, against the JAX
    package's ``position_sharding=`` run on its 8-device mesh: 1e-4."""
    outs, want = launches[0][nproc], launches[1][f"vi/{response}"]
    for out in outs:
        for k, v in want.items():
            np.testing.assert_allclose(out[f"vi/{response}/{k}"], v, atol=1e-4, rtol=0)


@RANKS
def test_rank_white_noise_is_the_one_process_rows(launches, nproc):
    """``white_noise`` on p ranks (K7's plain version, each rank its rows of
    ξ and its share of the visibilities): the one-process draw's rows, bit
    for bit; the replicated leaves the whole draw's.  Over ``nproc + 1``
    points too, whose shares differ by one (``np.array_split``'s blocks)."""
    outs, one = launches[0][nproc], launches[2]
    for r, out in enumerate(outs):
        for k in [k for k in one if k.startswith("white/")]:
            want = _rows(one[k], r, nproc) if k in ("white/data", "white/prior/cfxi") else one[k]
            np.testing.assert_array_equal(out[k], want)
        odd = f"odd{nproc}/white/"
        keys = [k for k in one if k.startswith(odd)]
        assert odd + "data" in keys and odd + "prior/cfxi" in keys
        for k in keys:
            want = one[k]
            if k == odd + "data":
                want = np.array_split(want, nproc)[r]
            elif k == odd + "prior/cfxi":
                want = _rows(want, r, nproc)
            np.testing.assert_array_equal(out["odd/white/" + k[len(odd):]], want)


@RANKS
def test_points_that_do_not_split_are_refused(launches, nproc):
    """``nufft2`` and SKI's interpolation of the row-sharded field at
    ``nproc + 1`` points, which split unevenly (the refusal is gone): each
    rank's share of the JAX package's values (``np.array_split``'s block),
    and the energy of a Gaussian over the visibilities, the JAX
    package's."""
    outs, want = launches[0][nproc], launches[1]
    for r, out in enumerate(outs):
        _close(out["odd/vis"], np.array_split(want[f"odd{nproc}/vis"], nproc)[r])
        _close(out["odd/ski"], np.array_split(want[f"odd{nproc}/ski"], nproc)[r])
        _close(out["odd/energy"], want[f"odd{nproc}/energy"], atol=1e-10)


def _extra_rows(want, k, r, p):
    if k.endswith("cfxi"):
        return _rows(want, r, p)
    return np.split(want, p, axis=1)[r] if k.endswith("spfftdelta_coord") else want


@RANKS
@pytest.mark.parametrize("response", ["learned", "shifted"])
def test_learned_coordinates_metric_energy_and_cotangent_match_jax(launches, nproc, response):
    """``VariablePositionNufft`` at coordinates ``base + UV · uv`` (49 points,
    uneven shares; ``uv`` replicated) and ``ShiftedPositionFFT`` (its shifts'
    rows split with the field's, its output the rank's rows) of exp(cf) on
    the row-sharded field: the metric, the energy and the coordinates'
    cotangent (the energy's gradient in ``uv`` or the shifts) are the JAX
    package's, 1e-10."""
    outs, want = launches[0][nproc], launches[1]
    extra = "uv" if response == "learned" else "spfftdelta_coord"
    for r, out in enumerate(outs):
        _close(out[f"{response}/energy"], want[f"{response}/energy"], atol=1e-10)
        for k in [k for k in want if k.startswith(f"{response}/metric/")]:
            _close(out[k], _extra_rows(want[k], k, r, nproc), atol=1e-10)
        _close(out[f"{response}/grad"], _extra_rows(want[f"{response}/grad"], extra, r, nproc), atol=1e-10)


MESHES = {2: ["fx", "s2f1"], 4: ["fx", "s2f2", "half0", "half1"]}


@pytest.mark.parametrize("nproc, run", [(n, m) for n in (2, 4) for m in MESHES[n]])
def test_learned_optimize_kl_with_own_kl_reduce_matches_jax(launches, nproc, run):
    """One MGVI iteration over the learned coordinates with a ``kl_reduce``
    of one's own (the 4 samples weighted), the JAX package's draws: on the
    field mesh, on a ("samples", "fx") mesh with the samples across ranks
    (2 × 1, 2 × 2), and on 4 ranks on two (1, 2) meshes over ranks {0, 1}
    and {2, 3} side by side, each with its own ``odir`` (written by the
    mesh's first rank; the second mesh then resumes from it alone), against
    the JAX package's ``position_sharding=`` run: 1e-4."""
    outs, want = launches[0][nproc], launches[1]["vi/learned"]
    mine = [out for r, out in enumerate(outs) if not run.startswith("half") or r // 2 == int(run[-1])]
    assert len(mine) == (2 if run.startswith("half") else nproc)
    for out in mine:
        for k, v in want.items():
            np.testing.assert_allclose(out[f"vi/learned_{run}/{k}"], v, atol=1e-4, rtol=0)
            if run == "half1":
                np.testing.assert_allclose(out[f"vi/learned_resumed/{k}"], v, atol=1e-4, rtol=0)
        if run == "half1":
            assert int(out["resumed_nit"]) == 1
    if run.startswith("half"):
        d = os.path.join(launches[3][nproc], run)
        smp, st = nt.io.load(os.path.join(d, "last.pkl"), "cpu")
        assert st.nit == 1 and len(smp) == 4
        for k, v in want.items():
            np.testing.assert_allclose(smp.pos[k].numpy(), v, atol=1e-4, rtol=0)


@RANKS
def test_light_cone_on_row_split_latent_matches_jax(launches, nproc):
    """``dynamic_lightcone_operator`` with its latent's rows split over the
    ranks (a 16 × 36 padded latent, 14 output rows: uneven over 4 ranks):
    each rank's rows of the JAX package's unsharded transfer field, and the
    pull-back of a cotangent of those rows (the latent's rows, the
    lightspeeds' latent whole), 1e-10 relative."""
    outs, want = launches[0][nproc], launches[1]
    for r, out in enumerate(outs):
        _close(out["cone/value"], np.array_split(want["cone/value"], nproc)[r], atol=1e-10)
        _close(out["cone/grad/dyn"], _rows(want["cone/grad/dyn"], r, nproc), atol=1e-10)
        _close(out["cone/grad/lc"], want["cone/grad/lc"], atol=1e-10)


@pytest.mark.parametrize("size", range(len(SMOKE)))
def test_large_field_step_on_two_ranks_matches_one_process(launches, size):
    """``_run_step`` on the port at 1024×512 knot16 and 128×64×16 knot8,
    float32, ``kl_map="smap"``: each rank holds n0/2 rows of the new ξ, the
    energy is finite, and the gathered step is the one-process port
    step's (relative L2 1e-5)."""
    outs, one = launches[0][2], launches[2]
    prefix = f"large{size}/"
    keys = [k[len(prefix):] for k in one if k.startswith(prefix) and k != prefix + "energy"]
    n0 = SMOKE[size][0][0]
    got = {}
    for r, out in enumerate(outs):
        assert tuple(out[prefix + "xi_rows"]) == (r * n0 // 2, n0 // 2)
        assert out[prefix + "cfxi"].shape[0] == n0 // 2 and out[prefix + "cfxi"].dtype == np.float32
        assert np.isfinite(out[prefix + "energy"])
        np.testing.assert_allclose(out[prefix + "energy"], one[prefix + "energy"], rtol=1e-5)
    for k in keys:
        got[k] = np.concatenate([o[prefix + k] for o in outs]) if k == "cfxi" else outs[0][prefix + k]
    num = sum(float(np.sum((got[k].astype(np.float64) - one[prefix + k]) ** 2)) for k in keys)
    den = sum(float(np.sum(one[prefix + k].astype(np.float64) ** 2)) for k in keys)
    assert (num / den) ** 0.5 <= 1e-5
