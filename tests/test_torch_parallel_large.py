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
each in a process of its own beside them.  (c) K7's plain version:
ranges of a draw against the whole draw, bit for bit, its moments and a
KS statistic; a p-rank ``white_noise`` against the one-process one.  (d)
The large-field step at ``_run_step``'s two smoke sizes on 2 ranks
against the one-process port step.  (e) The refusals that stay.

Tolerances, and why: the stages 1e-12 of the maximum (float64 FFTs and
sums in another order); the sharded metric and energy 1e-10 (as the
field's metric in ``test_torch_parallel.py``); one MGVI iteration against
the JAX package 1e-4 (the reference's own bound, ``tests/test_parallel.py``);
the large-field step 1e-5 relative L2 in float32 (the reductions of a
sharded run add in another order); K7's ranges exact; its moments within
5 standard errors at 10⁶ entries, the KS statistic below the 1e-3 level's
1.95/√n.
"""

import functools
import json
import os
import subprocess
import sys

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
from nifty_tpu_torch.parallel.nufft import nufft_stages

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
SMOKE = (((1024, 512), 16), ((128, 64, 16), 8))  # _run_step's CI sizes and knots
WHITE_KEY = 2**40 + 17


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


# --- (e) the refusals that stay --------------------------------------------------------------------


def test_coordinates_as_inputs_are_refused_on_a_sharded_field():
    """Inside a field context ``VariablePositionNufft``, ``ShiftedPositionFFT``,
    ``ToeplitzSKI`` and ``nufft2`` with coordinates that carry a gradient
    raise, naming ROADMAP.md (before any collective)."""
    vp = nt.ops.nufft.VariablePositionNufft((8, 8), 6)
    sp = nt.ops.nufft.ShiftedPositionFFT((8, 6))
    pts = np.random.default_rng(0).uniform(0.1, 0.9, (1, 6))
    toe = nt.ToeplitzSKI((8,), [(0.0, 1.0)], pts, kernel=lambda d: torch.exp(-d), **CPU)
    x = torch.zeros((4, 8), dtype=torch.float64)
    coords = torch.zeros((2, 6), dtype=torch.float64, requires_grad=True)
    with collectives.field_sharded(object(), ["cfxi"]):
        collectives.note_split(x, rows=True)
        for call in (lambda: vp({"nufftcoord": torch.zeros(2, 6), "nufftgrid": torch.zeros(8, 8)}),
                     lambda: sp({"spfftdelta_coord": torch.zeros(2, 8, 6), "spfftgrid": torch.zeros(8, 6)}),
                     lambda: toe(torch.zeros(6, dtype=torch.float64)),
                     lambda: nt.nufft2(x, coords)):
            with pytest.raises(NotImplementedError, match="ROADMAP.md"):
                call()
    assert nt.nufft2(x, coords.detach()).shape == (6,)  # outside the context: the whole image


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
from nifty_tpu_torch.parallel.collectives import field_sharded

parallel.initialize(store, nproc, rank, device="cpu")
inp = dict(np.load(os.path.join(d, "inputs.npz")))
cfg = json.load(open(os.path.join(d, "config.json")))
f64 = torch.float64
T = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
share = lambda a: np.split(a, nproc)[rank]  # noqa: E731
tree = lambda prefix: {k[len(prefix):]: inp[k] for k in inp if k.startswith(prefix)}  # noqa: E731
shape = tuple(cfg["shape"])
out = {}
mesh = parallel.global_mesh(("fx",))
cfm = nt.CorrelatedFieldMaker("cf")
cfm.set_amplitude_total_offset(0.5, (1e-1, 3e-2))
cfm.add_fluctuations(shape, 1.0 / shape[0], (1.0, 0.5), (-3.0, 0.2), (1.0, 0.2))
cf = cfm.finalize(device="cpu", dtype=f64, field_mesh=mesh)
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

# points that do not split over the ranks
odd = coords[:, :nproc + 1]
opt = nt.OptimizeVI(nt.Gaussian(torch.zeros(1, dtype=torch.complex128)).amend(
    lambda x: nt.nufft2(cf(x), odd)), 1, position_sharding=sh)
try:
    opt.draw_linear_samples(nt.position_from_numpy(cf, tree("start/"), sharding=sh), [1])
    out["odd_points"] = np.asarray("")
except NotImplementedError as e:
    out["odd_points"] = np.asarray(str(e))

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
    return inp


def _jax_vi(inp, name):
    """The JAX package's MGVI iteration over the NUFFT (``name`` "nufft") or
    SKI's interpolation ("ski") with ``position_sharding=`` on the
    conftest's 8-device mesh (in a process of its own, ``JAX_VI``)."""
    from jax.sharding import Mesh

    cfs = _jax_field(Mesh(np.asarray(jax.devices()), ("fx",)))
    lh = dict(zip(("nufft", "ski"), _jax_lhs(inp, cfs)))[name]
    # no status message: the JAX package's minisanity takes float() of a
    # complex residual's moments
    opt = nj.OptimizeVI(lh, 1, position_sharding=cfs.position_sharding(),
                        _get_status_message=lambda *a, **k: "")
    sj, _ = nj.optimize_kl(lh, _tree(inp, "start/"), n_total_iterations=1, n_samples=2,
                           key=random.PRNGKey(42), draw_linear_kwargs=dict(cg_kwargs=CG),
                           kl_kwargs=dict(minimize_kwargs=KL), sample_mode="linear_resample",
                           odir=None, position_sharding=cfs.position_sharding(), _optimize_vi=opt)
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
    """The JAX package's metrics and energies of both likelihoods."""
    want = {}
    for name, lh in zip(("nufft", "ski"), _jax_lhs(inp, _jax_field())):
        want[f"{name}/energy"] = np.asarray(jax.jit(lh)(_tree(inp, "mpos/")))
        metric = jax.jit(lh.metric)(_tree(inp, "mpos/"), _tree(inp, "mtan/"))
        want.update({f"{name}/metric/{k}": np.asarray(v) for k, v in dict(metric).items()})
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
    for i, (size, knots) in enumerate(SMOKE):
        _, x, e = large_field_step(size, knots, "cpu")
        one[f"large{i}/energy"] = e
        one.update({f"large{i}/{k}": v.numpy() for k, v in x.items()})
    return one


def _start(d, nproc, inp):
    d = str(d)
    np.savez(os.path.join(d, "inputs.npz"), **inp)
    cfg = dict(shape=list(SHAPE), noise=NOISE, cg=CG, kl=KL, white_key=WHITE_KEY, width=WIDTH,
               smoke=[[list(s), k] for s, k in SMOKE])
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
           for name in ("nufft", "ski")]
    want = _wants(inp)
    one = _one_process(inp)
    ranks = {n: _finish(*started[n]) for n in (2, 4)}
    _finish(d, vis, outputs=False)
    for name in ("nufft", "ski"):
        want[f"vi/{name}"] = dict(np.load(os.path.join(d, f"jax_vi_{name}.npz")))
    return ranks, want, one


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
    for bit; the replicated leaves the whole draw's."""
    outs, one = launches[0][nproc], launches[2]
    for r, out in enumerate(outs):
        for k in [k for k in one if k.startswith("white/")]:
            want = _rows(one[k], r, nproc) if k in ("white/data", "white/prior/cfxi") else one[k]
            np.testing.assert_array_equal(out[k], want)


@RANKS
def test_points_that_do_not_split_are_refused(launches, nproc):
    for out in launches[0][nproc]:
        msg = str(out["odd_points"])
        assert "ROADMAP.md" in msg and f"over {nproc} ranks" in msg


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
