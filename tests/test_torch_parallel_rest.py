"""Port parity: the rest of the multi-GPU surface against the JAX package,
on the CPU in float64.  Line-of-sight responses on a row-sharded field
(``ExactGridLOS``, ``SamplingCartesianGridLOS``, the reduce-scatter of
``parallel.collectives``), ``optimize_kl(odir=, resume=)`` with
``position_sharding=`` and ``devices=``, and ``nuts_sample(chain_map=
"pmap")``.

(a) Without processes: ``column_block`` tables and both LOS responses cut
to p = 1, 2, 4 and 8 virtual ranks, the ranks' partial ray sums added and
their pull-backs joined, against the whole and the JAX package's (a ray
that leaves the grid, NaN where the reference has it; sampled points
whose corners straddle two ranks).  (b) One launch of 2 gloo ranks and one
of 4 (the worker below, as in ``test_torch_parallel.py``): the sharded
tomography metric and energy, one MGVI iteration with ``position_sharding=``
over an ``ExactGridLOS``, ``odir`` with resume, NUTS chains across ranks;
the JAX package's ``position_sharding=`` run, whose compile is the longest
piece, runs in a process of its own beside them.
(c) Rays that do not split over the ranks (``np.array_split``'s shares;
the NUFFT's and SKI's points are ``test_torch_parallel_large.py``'s).

Tolerances, and why: partial sums and pull-backs 1e-12 of the maximum
(float64 sums in another order); the sharded metric and energy 1e-10 (as
the field's metric in ``test_torch_parallel.py``); one MGVI iteration
against the JAX package's ``position_sharding=`` run 1e-4 (the
reference's own bound, ``tests/test_parallel.py``); ``odir`` runs against
each other and the one-process port 1e-8 with CG and Newton-CG cut to a few
steps (past that, double rounding grows on these ill-conditioned
systems); ``"pmap"`` chains against ``"vmap"`` 1e-12 (each chain draws from
its own generator); against the JAX package's ``jax.pmap`` chains (other
random numbers) the moments within ``test_torch_mcmc.py``'s bounds.
"""

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
from jax.sharding import Mesh

import nifty_tpu as nj
import nifty_tpu.los as jlos
import nifty_tpu_torch as nt
from nifty_tpu.utils.tree import random_like as jax_random_like
from nifty_tpu_torch import io
from nifty_tpu_torch.ops.gather_reduce import PaddedSparse, column_block, transpose_block

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = dict(device="cpu", dtype=torch.float64)
SHAPE = (32, 32)
N_RAYS = 24  # splits over 2, 4 and 8 ranks
N_POINTS = 48
CG = dict(absdelta=1e-10, maxiter=100)
KL = dict(xtol=1e-8, maxiter=10)
SHORT_CG = dict(maxiter=5, miniter=5, resnorm=-1.0)
SHORT_KL = dict(maxiter=2, xtol=-1.0, cg_kwargs=SHORT_CG)
NUTS_SHORT = dict(n_chains=4, n_samples=6, n_warmup=30, max_tree_depth=5)
NUTS_LONG = dict(n_chains=4, n_samples=300, n_warmup=150, max_tree_depth=6)
DEVICES_PAIRS = 4  # sample pairs of the devices= runs


def _close(got, want, atol=1e-12):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0, atol=atol * max(np.nanmax(np.abs(want)), 1.0))


def _rays(seed=41, n=N_RAYS, leave=False):
    """Demo 1's rays across the unit square; with ``leave``, the last one
    runs out of the grid."""
    rng = np.random.default_rng(seed)
    starts = np.stack([np.zeros(n), rng.uniform(size=n)], axis=1)
    ends = np.stack([np.ones(n), rng.uniform(size=n)], axis=1)
    if leave:
        ends[-1] = (1.3, 0.5)
    return starts, ends


def _los_kw(n_points=True):
    kw = dict(shape=SHAPE, distances=(1.0 / SHAPE[0], 1.0 / SHAPE[1]))
    return dict(kw, n_sampling_points=N_POINTS) if n_points else kw


# --- (a) the row blocks, without processes ---------------------------------------------


@pytest.mark.parametrize("p", [1, 2, 4, 8])
def test_column_blocks_sum_to_the_whole_matrix(p):
    """``column_block`` of padded tables (a repeated column in a row, zero
    padding): the blocks' products summed and their transposes joined
    equal the whole matrix's, the blocks' indices int64 and local; the
    block's cell-major tables sliced from the whole's
    (``transpose_block``) are those built from the block."""
    rng = np.random.default_rng(p)
    n_cols, rows = 64, 10
    idx = rng.integers(0, n_cols, (rows, 7))
    idx[0, 1] = idx[0, 0]
    wgt = rng.standard_normal((rows, 7))
    wgt[3, 4:] = 0.0
    whole = PaddedSparse(idx, wgt, n_cols, **CPU)
    x, y = torch.from_numpy(rng.standard_normal(n_cols)), torch.from_numpy(rng.standard_normal(rows))
    b = n_cols // p
    parts, pulls = 0, []
    for r in range(p):
        bi, bw = column_block(idx, wgt, r * b, (r + 1) * b)
        assert bi.dtype == np.int64 and bi.shape[0] == rows and (bi >= 0).all() and (bi < b).all()
        block = PaddedSparse(bi, bw, b, **CPU)
        sliced = PaddedSparse(bi, bw, b, **CPU, transpose=transpose_block(
            whole.cols.numpy(), whole.t_rows.numpy(), whole.t_wgt.numpy(), r * b, (r + 1) * b))
        for name in ("cols", "t_rows", "t_wgt"):
            assert torch.equal(getattr(sliced, name), getattr(block, name))
        parts = parts + block @ x[r * b:(r + 1) * b]
        pulls.append(block.T @ y)
    _close(parts.numpy(), (whole @ x).numpy())
    _close(torch.cat(pulls).numpy(), (whole.T @ y).numpy())


def _jax_los(kind, starts, ends):
    if kind == "exact":
        return jlos.ExactGridLOS(starts, ends, **_los_kw(False))
    return jlos.SamplingCartesianGridLOS(starts, ends, **_los_kw())


def _port_los(kind, starts, ends):
    if kind == "exact":
        return nt.ExactGridLOS(starts, ends, **_los_kw(False), **CPU)
    return nt.SamplingCartesianGridLOS(starts, ends, **_los_kw(), **CPU)


@pytest.mark.parametrize("kind", ["exact", "sampled"])
@pytest.mark.parametrize("p", [1, 2, 4, 8])
def test_los_row_partials_match_jax(kind, p):
    """A rank's partial integrals of its rows, summed over p virtual ranks,
    and the pull-backs of the whole cotangent through each rank's rows,
    joined: the JAX package's response and its vjp.  One ray leaves the
    grid: the sampled response is NaN there on every rank (and in the
    reference), the exact one cuts it; the sampled points' corners
    straddle the ranks' rows."""
    starts, ends = _rays(leave=True)
    rng = np.random.default_rng(7)
    x, cot = rng.standard_normal(SHAPE), rng.standard_normal(N_RAYS)
    ref = _jax_los(kind, starts, ends)
    want = np.asarray(ref(jnp.asarray(x)))
    want_pull = np.asarray(jax.vjp(ref, jnp.asarray(x))[1](jnp.asarray(cot))[0])
    los = _port_los(kind, starts, ends)
    b = SHAPE[0] // p
    xt, ct = torch.from_numpy(x), torch.from_numpy(cot)
    parts, pulls = [], []
    for r in range(p):
        rows = xt[r * b:(r + 1) * b]
        parts.append(los.rows_partial(rows, r * b))
        _, pull = torch.func.vjp(lambda v, r=r: los.rows_partial(v, r * b), rows)
        pulls.append(pull(ct)[0])
    got = sum(parts).numpy()
    nan = np.isnan(want)
    assert nan.any() == (kind == "sampled")
    np.testing.assert_array_equal(np.isnan(got), nan)
    for part in parts:  # the ray out of the grid is NaN on every rank
        np.testing.assert_array_equal(np.isnan(part.numpy()), nan)
    _close(got[~nan], want[~nan])
    _close(torch.cat(pulls).numpy(), want_pull)
    assert kind != "exact" or len(los.row_tables) == (0 if p == 1 else p)  # all rows: the table


def test_map_coordinates_rows_outside_the_rank_add_nothing():
    """A point between two ranks' rows takes each corner from its own rank;
    a point outside the whole grid is NaN on every rank, one merely outside
    a rank's rows 0 there."""
    from nifty_tpu_torch.ops.ndimage import map_coordinates

    grid = torch.from_numpy(np.random.default_rng(3).standard_normal((8, 5)))
    pts = torch.tensor([[3.5, 0.2, 9.0, -0.5], [2.25, 3.0, 1.0, 1.0]], dtype=torch.float64)
    whole = map_coordinates(grid, pts, 1, cval=float("nan"))
    lo = map_coordinates(grid[:4], pts, 1, cval=float("nan"), rows=(0, 8))
    hi = map_coordinates(grid[4:], pts, 1, cval=float("nan"), rows=(4, 8))
    assert torch.isnan(whole[2:]).all() and torch.isnan(lo[2:]).all() and torch.isnan(hi[2:]).all()
    assert float(hi[1]) == 0.0 and float(lo[1]) != 0.0
    _close((lo + hi)[:2].numpy(), whole[:2].numpy())
    with pytest.raises(ValueError, match="outside"):
        map_coordinates(grid[:4], pts, 1, rows=(6, 8))


# --- (b) the ranks: 2 and 4 gloo processes -----------------------------------------------

WORKER = r'''
import json, os, sys
rank, nproc, store, d, root = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4], sys.argv[5]
sys.path.insert(0, root)
import numpy as np
import torch
torch.set_num_threads(1)
import nifty_tpu_torch as nt
from nifty_tpu_torch import io, parallel
from nifty_tpu_torch.evi import seeds
from nifty_tpu_torch.parallel.collectives import field_sharded

parallel.initialize(store, nproc, rank, device="cpu")
inp = dict(np.load(os.path.join(d, "inputs.npz")))
cfg = json.load(open(os.path.join(d, "config.json")))
f64 = torch.float64
T = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
share = lambda a: np.array_split(a, nproc)[rank]  # noqa: E731
tree = lambda prefix: {k[len(prefix):]: inp[k] for k in inp if k.startswith(prefix)}  # noqa: E731
shape = tuple(cfg["shape"])
out = {}
mesh = parallel.global_mesh(("fx",))


def field(sharded=True):
    cfm = nt.CorrelatedFieldMaker("cf")
    cfm.set_amplitude_total_offset(0.5, (1e-1, 3e-2))
    cfm.add_fluctuations(shape, 1.0 / shape[0], (1.0, 0.5), (-3.0, 0.2), (1.0, 0.2))
    return cfm.finalize(device="cpu", dtype=f64, field_mesh=mesh if sharded else None)


kw = dict(shape=shape, distances=(1.0 / shape[0], 1.0 / shape[1]), device="cpu", dtype=f64)
exact = nt.ExactGridLOS(inp["starts"], inp["ends"], **kw)
sampled = nt.SamplingCartesianGridLOS(inp["starts"], inp["ends"], n_sampling_points=cfg["points"], **kw)
cf = field()
sh = cf.position_sharding()
dens = nt.ChainModel(torch.exp, cf)


def lh_of(los, data, sharded=True, model=None):
    model = model or (dens if sharded else nt.ChainModel(torch.exp, field(False)))
    data = share(data) if sharded else data
    return nt.Gaussian(T(data), noise_std_inv=lambda x: x / cfg["noise"], device="cpu").amend(
        nt.ChainModel(los, model))


# the tomography metric and energy through both responses, inside the field context
lh = lh_of(exact, inp["data_exact"]) + lh_of(sampled, inp["data_sampled"])
with field_sharded(mesh.get_group("fx"), [k for k, v in sh.items() if v.split_axes()]):
    pos = nt.position_from_numpy(cf, tree("mpos/"), sharding=sh)
    m = lh.metric(pos, nt.position_from_numpy(cf, tree("mtan/"), sharding=sh))
    out["energy"] = lh(pos).detach().numpy()
for k, v in m.items():
    out["metric/" + k] = v.detach().numpy()

# one MGVI iteration by position_sharding= over the exact LOS, the JAX package's draws
lh_e = lh_of(exact, inp["data_exact"])
order = seeds(torch.Generator().manual_seed(42), 2)


def linear(lh_, pos, seed, **kw):
    i = order.index(seed)
    prior = {k: T(share(v)) if k == "cfxi" else T(v) for k, v in sorted(tree(f"white{i}/prior/").items())}
    return nt.draw_linear_residual(lh_, pos, white=nt.WhiteNoise(T(share(inp[f"white{i}/data"])), prior), **kw)


opt = nt.OptimizeVI(lh_e, 1, position_sharding=sh, _draw_linear_residual=linear)
s, _ = nt.optimize_kl(lh_e, nt.position_from_numpy(cf, tree("start/"), sharding=sh),
                      key=torch.Generator().manual_seed(42), n_total_iterations=1, n_samples=2,
                      draw_linear_kwargs=dict(cg_kwargs=cfg["cg"]), kl_kwargs=dict(minimize_kwargs=cfg["kl"]),
                      sample_mode="linear_resample", _optimize_vi=opt)
for k, v in opt.gather(s).pos.items():
    out["vi_los/" + k] = v.numpy()

# odir: two iterations straight, and one then a resume, by position_sharding= and by devices=
for name, lh_, start, run_kw, pairs in (
        ("ps", lh_e, nt.position_from_numpy(cf, tree("start/"), sharding=sh), dict(position_sharding=sh), 2),
        ("dv", lh_of(exact, inp["data_exact"], sharded=False),
         nt.position_from_numpy(field(False), tree("start/")), dict(devices=parallel.sample_mesh()),
         cfg["devices_pairs"])):
    export = {"cf": cf if name == "ps" else field(False)}
    for odir, its in ((f"{name}_straight", (2,)), (f"{name}_resumed", (1, 2))):
        for n_it in its:
            s, st = nt.optimize_kl(
                lh_, start, key=torch.Generator().manual_seed(43), n_total_iterations=n_it,
                n_samples=pairs, draw_linear_kwargs=dict(cg_kwargs=cfg["short_cg"]),
                kl_kwargs=dict(minimize_kwargs=cfg["short_kl"]), sample_mode="linear_resample",
                odir=os.path.join(d, odir), resume=n_it == 2 and odir.endswith("resumed"),
                export_operators=export, **run_kw)
        whole = nt.OptimizeVI(lh_, 2, **run_kw).gather(s)
        for k, v in whole.pos.items():
            out[f"{odir}/pos/{k}"] = v.numpy()
        for k, v in whole._samples.items():
            out[f"{odir}/samples/{k}"] = v.numpy()
        out[f"{odir}/nit"] = np.asarray(st.nit)

# rays that do not split over the ranks: the metric and energy through both responses
n_odd = nproc + 1
odd = nt.ExactGridLOS(inp["starts"][:n_odd], inp["ends"][:n_odd], **kw)
odd_s = nt.SamplingCartesianGridLOS(inp["starts"][:n_odd], inp["ends"][:n_odd], n_sampling_points=cfg["points"],
                                    **kw)
lh_o = lh_of(odd, inp["data_exact"][:n_odd]) + lh_of(odd_s, inp["data_sampled"][:n_odd])
with field_sharded(mesh.get_group("fx"), [k for k, v in sh.items() if v.split_axes()]):
    pos = nt.position_from_numpy(cf, tree("mpos/"), sharding=sh)
    m = lh_o.metric(pos, nt.position_from_numpy(cf, tree("mtan/"), sharding=sh))
    out["odd_rays/energy"] = lh_o(pos).detach().numpy()
for k, v in m.items():
    out["odd_rays/metric/" + k] = v.detach().numpy()

# NUTS chains across the ranks
logd = lambda q: -0.5 * (torch.sum(q["a"] ** 2 / 4.0) + q["b"] ** 2)  # noqa: E731
proto = {"a": torch.zeros(2, dtype=f64), "b": torch.zeros((), dtype=f64)}
smp, info = nt.nuts_sample(logd, torch.Generator().manual_seed(7), position_proto=proto,
                           chain_map="pmap", **cfg["nuts_short"])
for k, v in smp.samples.items():
    out["nuts/" + k] = v.numpy()
for k in ("step_size", "acceptance", "tree_depths", "divergences", "leapfrog_steps"):
    out["nuts_info/" + k] = info[k].numpy()
if nproc == 4:
    smp, info = nt.nuts_sample(lambda q: -0.5 * torch.sum(q ** 2), 4, chain_map="pmap",
                               position_proto=torch.zeros(2, dtype=f64), **cfg["nuts_long"])
    out["nuts_long"] = smp.samples.numpy()
    out["nuts_long_acceptance"] = info["acceptance"].numpy()
np.savez(os.path.join(d, f"out{rank}.npz"), **out)
print("done", rank, flush=True)
'''


def _jax_field(mesh=None):
    cfm = nj.CorrelatedFieldMaker("cf")
    cfm.set_amplitude_total_offset(0.5, (1e-1, 3e-2))
    cfm.add_fluctuations(SHAPE, 1.0 / SHAPE[0], (1.0, 0.5), (-3.0, 0.2), (1.0, 0.2))
    return cfm.finalize() if mesh is None else cfm.finalize(field_mesh=mesh)


NOISE = 0.05


def _jax_lh(los, data, cf):
    return nj.Gaussian(jnp.asarray(data), noise_std_inv=lambda x: x / NOISE).amend(
        lambda x: los(jnp.exp(cf(x))))


def _draw(domain, rng, scale=1.0):
    return {k: scale * rng.standard_normal(v.shape) for k, v in sorted(domain.items())}


def _inputs():
    rng = np.random.default_rng(13)
    starts, ends = _rays()
    cf = _jax_field()
    inp = {"starts": starts, "ends": ends}
    truth = cf.init(random.PRNGKey(10))
    rho = jax.jit(lambda p: jnp.exp(cf(p)))(truth)
    for kind in ("exact", "sampled"):
        line = np.asarray(_jax_los(kind, starts, ends)(rho))
        inp[f"data_{kind}"] = line + NOISE * rng.standard_normal(line.shape)
    for name, scale in (("mpos", 0.3), ("mtan", 1.0), ("start", 0.1)):
        inp.update({f"{name}/{k}": v for k, v in _draw(cf.domain, rng, scale).items()})
    lhj = _jax_lh(_jax_los("exact", starts, ends), inp["data_exact"], cf)
    start = {k[6:]: v for k, v in inp.items() if k.startswith("start/")}
    _, sk = random.split(random.PRNGKey(42), 2)
    for i, k in enumerate(random.split(sk, 2)):  # the keys of the iteration's draws
        k_nll, k_prr = random.split(k, 2)
        inp[f"white{i}/data"] = np.array(jax_random_like(k_nll, lhj.left_sqrt_metric_tangents_shape))
        prior = jax_random_like(k_prr, start)
        for name, v in zip(sorted(start), jax.tree_util.tree_leaves(prior)):
            inp[f"white{i}/prior/{name}"] = np.array(v)
    return inp


def _tree(inp, prefix):
    return {k[len(prefix):]: jnp.asarray(v) for k, v in inp.items() if k.startswith(prefix)}


def _jax_vi(inp):
    """The JAX package's MGVI iteration with ``position_sharding=`` on the
    conftest's 8-device mesh (its compile takes most of this module's time,
    so :func:`launches` runs it in a process of its own, ``JAX_VI``)."""
    mesh = Mesh(np.asarray(jax.devices()), ("fx",))
    cfs = _jax_field(mesh)
    lhs = _jax_lh(_jax_los("exact", inp["starts"], inp["ends"]), inp["data_exact"], cfs)
    sj, _ = nj.optimize_kl(lhs, _tree(inp, "start/"), n_total_iterations=1, n_samples=2,
                           key=random.PRNGKey(42), draw_linear_kwargs=dict(cg_kwargs=CG),
                           kl_kwargs=dict(minimize_kwargs=KL), sample_mode="linear_resample",
                           odir=None, position_sharding=cfs.position_sharding())
    return {k: np.asarray(v) for k, v in dict(getattr(sj.pos, "tree", sj.pos)).items()}


JAX_VI = r'''
import os, sys
d, root = sys.argv[1], sys.argv[2]
sys.path[:0] = [os.path.join(root, "tests"), root]
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
import numpy as np
import test_torch_parallel_rest as t
np.savez(os.path.join(d, "jax_vi.npz"), **t._jax_vi(dict(np.load(os.path.join(d, "inputs.npz")))))
'''


def _wants(inp):
    """The JAX package's tomography metric and energy, and its NUTS chains
    by ``jax.pmap``."""
    starts, ends = inp["starts"], inp["ends"]
    cf = _jax_field()
    lh = (_jax_lh(_jax_los("exact", starts, ends), inp["data_exact"], cf)
          + _jax_lh(_jax_los("sampled", starts, ends), inp["data_sampled"], cf))
    want = {"energy": np.asarray(jax.jit(lh)(_tree(inp, "mpos/")))}
    metric = jax.jit(lh.metric)(_tree(inp, "mpos/"), _tree(inp, "mtan/"))
    want.update({"metric/" + k: np.asarray(v) for k, v in dict(metric).items()})
    for p in (2, 4):  # rays that do not split over p ranks
        n = p + 1
        lh = (_jax_lh(_jax_los("exact", starts[:n], ends[:n]), inp["data_exact"][:n], cf)
              + _jax_lh(_jax_los("sampled", starts[:n], ends[:n]), inp["data_sampled"][:n], cf))
        want[f"odd{p}/energy"] = np.asarray(jax.jit(lh)(_tree(inp, "mpos/")))
        metric = jax.jit(lh.metric)(_tree(inp, "mpos/"), _tree(inp, "mtan/"))
        want.update({f"odd{p}/metric/" + k: np.asarray(v) for k, v in dict(metric).items()})
    sn, _ = nj.nuts_sample(lambda q: -0.5 * jnp.sum(q**2), random.PRNGKey(4),
                           position_proto=jnp.zeros(2), chain_map=jax.pmap, **NUTS_LONG)
    want["nuts_long"] = np.asarray(sn.samples)
    return want


def _one_process(inp, odir):
    """The port's one-process runs the ranks' must reproduce: ``odir`` runs
    of two iterations, 2 and ``DEVICES_PAIRS`` sample pairs, and the
    ``"vmap"`` chains of the worker's short NUTS run."""
    cfm = nt.CorrelatedFieldMaker("cf")
    cfm.set_amplitude_total_offset(0.5, (1e-1, 3e-2))
    cfm.add_fluctuations(SHAPE, 1.0 / SHAPE[0], (1.0, 0.5), (-3.0, 0.2), (1.0, 0.2))
    cf = cfm.finalize(**CPU)
    los = nt.ExactGridLOS(inp["starts"], inp["ends"], **_los_kw(False), **CPU)
    lh = nt.Gaussian(torch.from_numpy(inp["data_exact"]), noise_std_inv=lambda x: x / NOISE).amend(
        nt.ChainModel(los, nt.ChainModel(torch.exp, cf)))
    start = nt.position_from_numpy(cf, {k[6:]: v for k, v in inp.items() if k.startswith("start/")})
    runs = {}
    for pairs in (2, DEVICES_PAIRS):
        path = os.path.join(odir, f"one{pairs}")
        runs[pairs] = nt.optimize_kl(
            lh, start, key=torch.Generator().manual_seed(43), n_total_iterations=2, n_samples=pairs,
            draw_linear_kwargs=dict(cg_kwargs=SHORT_CG), kl_kwargs=dict(minimize_kwargs=SHORT_KL),
            sample_mode="linear_resample", odir=path, export_operators={"cf": cf})[0], path
    logd = lambda q: -0.5 * (torch.sum(q["a"] ** 2 / 4.0) + q["b"] ** 2)  # noqa: E731
    proto = {"a": torch.zeros(2, dtype=torch.float64), "b": torch.zeros((), dtype=torch.float64)}
    runs["nuts"] = nt.nuts_sample(logd, torch.Generator().manual_seed(7), position_proto=proto,
                                  **NUTS_SHORT)
    return runs


def _start(d, nproc, inp):
    d = str(d)
    np.savez(os.path.join(d, "inputs.npz"), **inp)
    cfg = dict(shape=list(SHAPE), points=N_POINTS, noise=NOISE, cg=CG, kl=KL, short_cg=SHORT_CG,
               short_kl=SHORT_KL, devices_pairs=DEVICES_PAIRS, nuts_short=NUTS_SHORT,
               nuts_long=NUTS_LONG)
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
        return d, [dict(np.load(os.path.join(d, f"out{r}.npz"))) for r in range(len(procs))]


@pytest.fixture(scope="module")
def launches(tmp_path_factory):
    """One launch of 2 ranks and one of 4, side by side; the JAX package's
    results and the port's one-process runs are computed while they run."""
    inp = _inputs()
    started = {n: _start(tmp_path_factory.mktemp(f"ranks{n}"), n, inp) for n in (2, 4)}
    d = str(tmp_path_factory.mktemp("jax_vi"))
    np.savez(os.path.join(d, "inputs.npz"), **inp)
    with open(os.path.join(d, "jax_vi.py"), "w") as f:
        f.write(JAX_VI)
    vi = subprocess.Popen([sys.executable, os.path.join(d, "jax_vi.py"), d, ROOT],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    want = _wants(inp)
    one = _one_process(inp, str(tmp_path_factory.mktemp("one")))
    ranks = {n: _finish(*started[n]) for n in (2, 4)}
    _finish(d, [vi], outputs=False)
    want["vi_los"] = dict(np.load(os.path.join(d, "jax_vi.npz")))
    return ranks, want, one


RANKS = pytest.mark.parametrize("nproc", [2, 4])


def _rows(a, rank, p):
    return np.split(a, p)[rank]


@RANKS
def test_sharded_tomography_metric_matches_jax(launches, nproc):
    """The metric and energy of a Gaussian over the exact and the sampled
    LOS of exp(cf), the field row-sharded, the rays' data each rank's
    share: the JAX package's (ξ's rows, the rest whole, the energy once)."""
    (_, outs), want = launches[0][nproc], launches[1]
    for r, out in enumerate(outs):
        _close(out["energy"], want["energy"], atol=1e-10)
        for k in [k for k in want if k.startswith("metric/")]:
            _close(out[k], _rows(want[k], r, nproc) if k.endswith("cfxi") else want[k], atol=1e-10)


@RANKS
def test_position_sharded_los_optimize_kl_matches_jax(launches, nproc):
    """One MGVI iteration with ``position_sharding=`` over an ``ExactGridLOS``
    (the JAX package's draws), gathered, against the JAX package's
    ``position_sharding=`` run on its 8-device mesh: 1e-4."""
    (_, outs), want = launches[0][nproc], launches[1]
    for out in outs:
        for k, v in want["vi_los"].items():
            np.testing.assert_allclose(out["vi_los/" + k], v, atol=1e-4, rtol=0)


def _same(a, b):
    return sorted(a) == sorted(b) and all(np.shape(a[k]) == np.shape(b[k]) for k in a)


@RANKS
@pytest.mark.parametrize("run", ["ps", "dv"])
def test_odir_resume_across_ranks_matches_one_process(launches, nproc, run):
    """``odir`` with ``position_sharding=`` (ps) and ``devices=`` (dv): two
    iterations straight against one and a resume, and ``last.pkl`` (written
    by the first rank from the gathered samples, in the one-process format)
    and the exported field against the one-process port's files: 1e-8."""
    (d, outs), one = launches[0][nproc], launches[2]
    pairs = 2 if run == "ps" else DEVICES_PAIRS
    ref, ref_dir = one[pairs]
    for out in outs:
        for part in ("pos", "samples"):
            straight = {k.split("/")[-1]: v for k, v in out.items() if k.startswith(f"{run}_straight/{part}/")}
            resumed = {k.split("/")[-1]: v for k, v in out.items() if k.startswith(f"{run}_resumed/{part}/")}
            assert straight and _same(straight, resumed)
            for k in straight:
                _close(resumed[k], straight[k], atol=1e-8)
        assert int(out[f"{run}_resumed/nit"]) == 2
    for odir in ("straight", "resumed"):
        path = os.path.join(d, f"{run}_{odir}")
        smp, st = io.load(os.path.join(path, "last.pkl"), "cpu")
        assert st.nit == 2 and smp.keys == ref.keys and len(smp) == 2 * pairs
        for k, v in ref.pos.items():
            _close(smp.pos[k].numpy(), v.numpy(), atol=1e-8)
        for k, v in ref._samples.items():
            _close(smp._samples[k].numpy(), v.numpy(), atol=1e-8)
        assert io.load_samples(os.path.join(path, "last.pkl"), "cpu").keys == ref.keys
        got = np.load(os.path.join(path, "operator_outputs", "cf_last.npz"))
        exp = np.load(os.path.join(ref_dir, "operator_outputs", "cf_last.npz"))
        for k in ("mean", "std"):
            _close(got[k], exp[k], atol=1e-8)
        assert int(got["nit"]) == 2
        with open(os.path.join(path, "minisanity.txt")) as f:
            assert f.read().count("Iteration 0002") == 1


@RANKS
def test_rays_that_do_not_split_are_refused(launches, nproc):
    """``nproc + 1`` rays, which split unevenly over the ranks (the refusal
    is gone; ``np.array_split``'s shares of the data): the metric and energy
    of a Gaussian over the exact and the sampled LOS of exp(cf), the JAX
    package's, 1e-10."""
    (_, outs), want = launches[0][nproc], launches[1]
    for r, out in enumerate(outs):
        _close(out["odd_rays/energy"], want[f"odd{nproc}/energy"], atol=1e-10)
        for k in [k for k in want if k.startswith(f"odd{nproc}/metric/")]:
            got = out["odd_rays/metric/" + k.split("/")[-1]]
            _close(got, _rows(want[k], r, nproc) if k.endswith("cfxi") else want[k], atol=1e-10)


@RANKS
def test_nuts_pmap_chains_match_vmap(launches, nproc):
    """``nuts_sample(chain_map="pmap")``, 4 chains over the ranks, each rank
    its block by ``"vmap"``: every rank returns the chains of the
    one-process ``"vmap"`` run, gathered in chain order."""
    (_, outs), (smp, info) = launches[0][nproc], launches[2]["nuts"]
    for out in outs:
        for k, v in smp.samples.items():
            _close(out["nuts/" + k], v.numpy())
        for k in ("step_size", "acceptance", "tree_depths", "divergences"):
            _close(out["nuts_info/" + k], info[k].numpy())
        assert out["nuts_info/leapfrog_steps"].shape == info["leapfrog_steps"].shape


def test_nuts_pmap_moments_match_jax_pmap(launches):
    """4 chains, one a rank, on a 2-D standard normal, against the JAX
    package's ``chain_map=jax.pmap`` on 4 devices: the moments within
    ``test_torch_mcmc.py``'s bounds of each other and of the target."""
    (_, outs), want = launches[0][4], launches[1]
    jx = want["nuts_long"]
    assert jx.shape == (4 * NUTS_LONG["n_samples"], 2)
    for out in outs:
        got = out["nuts_long"]
        assert got.shape == jx.shape and np.all(out["nuts_long_acceptance"] > 0.5)
        np.testing.assert_allclose(got.std(axis=0), jx.std(axis=0), rtol=0.25)
        np.testing.assert_allclose(got.mean(axis=0), jx.mean(axis=0), atol=0.15)
        np.testing.assert_allclose(got.std(axis=0), 1.0, rtol=0.25)
        np.testing.assert_allclose(got.mean(axis=0), 0.0, atol=0.15)
