"""The hand-written CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips without a CUDA device.  This file imports
neither jax nor nifty_tpu, so it runs where only PyTorch is installed:
``python -m pytest --noconftest -m cuda tests/test_torch_cuda.py`` (the
shared ``tests/conftest.py`` imports jax).

On the card the port's entry points build on the card by default
(``finalize()``, ``position_from_numpy``, a likelihood given numpy data).

Tolerances: K1 exact (a gather computes nothing); K2 relative 1e-6 against
a float64 segment sum (f32 sums over one bin in a fixed order); the
Hartley max|Δ|/max|ref| <= 1e-5 (f32 FFT rounding); the metric relative L2
<= 1e-4 against float64 on the CPU (f32 through exp and three Hartleys),
for the exact and the 64-knot form.
"""

import copy

import numpy as np
import pytest
import torch

import nifty_tpu_torch as nt
from nifty_tpu_torch import native
from nifty_tpu_torch.bench.workload import (bench_field, build_likelihood, build_vi_likelihood,
                                             grid_index)
from nifty_tpu_torch.ops import cuda_expand as ce
from nifty_tpu_torch.ops import cuda_fft as cfft
from nifty_tpu_torch.ops import mode_expand as me

pytestmark = pytest.mark.cuda
torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda:0")


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


def _index(P, U, seed, big_bin=0):
    """A random flat 1-D index (full shape = core shape (P,))."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, U, P)
    idx[:U] = np.arange(U)  # every bin non-empty
    if big_bin:
        idx[U : U + big_bin] = 3  # one bin reduced by a warp
    layout = me.ExpandLayout("flat", (P,), (P,), U, "")
    return ce.ExpandIndex(idx, layout), (P,)


def _grid_index(full):
    return grid_index(full), full


CASES = {
    "rfp2_1280": lambda: _grid_index((1280, 1280)),
    "rfp2_1292": lambda: _grid_index((1292, 1292)),  # n/2 = 2 mod 4: runs cut at the centre
    "rfp2_1281": lambda: _grid_index((1281, 1281)),  # odd n: runs of one point
    "flat_1282": lambda: _grid_index((1282, 1282)),  # n = 2 mod 4: H even, flat
    "flat_768x1280": lambda: _grid_index((768, 1280)),
    "flat_1d": lambda: _grid_index((100_002,)),
    "flat_3d": lambda: _grid_index((48, 64, 90)),
    "bin_of_5000": lambda: _index(200_003, 90_001, 0, big_bin=5000),
}


@pytest.mark.parametrize("B", [1, 4, 3])
@pytest.mark.parametrize("case", sorted(CASES))
def test_gather_and_segment_sum(cuda_device, case, B):
    """K1 equals its plain version bit for bit; K2 is within 1e-6 of a
    float64 plain version and gives the same bits twice."""
    index, full = CASES[case]()
    if case.startswith("rfp2"):
        assert index.layout.kind == "rfp2"
    if case == "bin_of_5000":
        assert index.large_bins.tolist() == [3]
    index_d = copy.deepcopy(index).to(cuda_device)
    seed = B + (5000 if case == "bin_of_5000" else 0)  # the same data every run
    g = torch.Generator(device=cuda_device).manual_seed(seed)
    batch = () if B == 1 else (B,)
    tab = torch.randn((index.n_unique,) + batch, device=cuda_device, generator=g)
    native.reset_launches()
    out = ce.expand_to_grid(tab, index_d, full)
    assert native.launches["expand_to_grid"] == 1
    assert torch.equal(out, ce.expand_to_grid_plain(tab, index_d, full))
    cot = torch.randn(tuple(full) + batch, device=cuda_device, generator=g)
    seg = ce.collapse_from_grid(cot, index_d, full)
    assert native.launches["collapse_from_grid"] == 1
    assert torch.equal(seg, ce.collapse_from_grid(cot, index_d, full))  # deterministic
    ref = ce.collapse_from_grid_plain(cot.double().cpu(), index, full)
    assert _rel(seg.double().cpu(), ref) <= 1e-6


def test_grid_kernels_realign_an_offset_batch(cuda_device):
    """At B = 4 K1 and K2 load 16-byte vectors: the wrappers refuse a
    contiguous input that starts off a 16-byte boundary, and the autograd
    pair hands them an aligned copy."""
    index, full = CASES["rfp2_1280"]()
    index_d = copy.deepcopy(index).to(cuda_device)
    U, N, B = index.n_unique, full[0] * full[1], 4
    g = torch.Generator(device=cuda_device).manual_seed(7)
    tab = torch.randn(U * B + 1, device=cuda_device, generator=g)[1:].view(U, B)
    cot = torch.randn(N * B + 1, device=cuda_device, generator=g)[1:].view(full + (B,))
    for t in (tab, cot):
        assert t.is_contiguous() and t.data_ptr() % 16
    with pytest.raises(ValueError):
        ce.expand_to_grid(tab, index_d, full)
    with pytest.raises(ValueError):
        ce.collapse_from_grid(cot, index_d, full)
    native.reset_launches()
    out = me.mode_expand_grid(tab, index_d, full)
    seg = me.ModeCollapseGrid.apply(cot, index_d, full)
    assert native.launches["expand_to_grid"] == 1 and native.launches["collapse_from_grid"] == 1
    assert torch.equal(out, ce.expand_to_grid_plain(tab, index_d, full))
    ref = ce.collapse_from_grid_plain(cot.double().cpu(), index, full)
    assert _rel(seg.double().cpu(), ref) <= 1e-6


def test_wrappers_raise_on_bad_cuda_input(cuda_device):
    index, full = _index(1000, 100, 1)
    index_d = copy.deepcopy(index).to(cuda_device)
    with pytest.raises(TypeError):
        ce.expand_to_grid(torch.zeros(100, device=cuda_device, dtype=torch.float64), index_d, full)
    with pytest.raises(ValueError):
        ce.expand_to_grid(torch.zeros(101, device=cuda_device), index_d, full)
    with pytest.raises(ValueError):
        ce.collapse_from_grid(torch.zeros((2, 1000), device=cuda_device).T, index_d, full)
    with pytest.raises(TypeError):
        ce.collapse_from_grid(torch.zeros(1000, device=cuda_device, dtype=torch.float64), index_d, full)
    with pytest.raises(ValueError):
        ce.expand_to_grid(torch.zeros(100, device=cuda_device), index, full)  # index on CPU
    with pytest.raises(ValueError):
        ce.collapse_from_grid(torch.zeros(1000, device=cuda_device), index, full)
    with pytest.raises(TypeError):
        cfft.hartley_rows(torch.zeros((256, 256), device=cuda_device, dtype=torch.float64))
    with pytest.raises(ValueError):
        cfft.hartley_rows(torch.zeros((256, 512), device=cuda_device).T)
    with pytest.raises(ValueError):
        cfft.hartley_rows(torch.zeros((256, 300), device=cuda_device))
    with pytest.raises(ValueError):  # rows pair up: an odd count
        cfft.hartley_rows(torch.zeros((321, 256), device=cuda_device))
    G = torch.zeros((256, 129), device=cuda_device, dtype=torch.complex64)
    with pytest.raises(ValueError):  # row pitch 129: K4 takes no unpadded half spectrum
        cfft.hartley_cols(G, 256)
    with pytest.raises(ValueError):
        cfft.hartley_cols(torch.zeros((136, 256), device=cuda_device, dtype=torch.complex64).T[:, :129], 256)
    with pytest.raises(TypeError):
        cfft.hartley_cols(cfft.padded_half_spectrum(G).real, 256)


@pytest.mark.parametrize(
    "shape",
    [(256, 256), (512, 768), (1280, 1280), (256, 1792), (2048, 512), (10240, 256), (256, 10240),
     (768, 1280), (1792, 256), (4096, 4096), (12288, 256), (24576, 256)],
)
def test_hartley_kernels(cuda_device, shape):
    x = torch.randn(shape, device=cuda_device)
    G = cfft.hartley_rows(x)
    Gp = cfft.hartley_rows_plain(x)
    assert _rel(G, Gp) <= 1e-5
    H = cfft.hartley_cols(cfft.padded_half_spectrum(Gp), shape[1])
    Hp = cfft.hartley_cols_plain(Gp, shape[1])
    assert _rel(H, Hp) <= 1e-5
    full = cfft.hartley2d(x)
    ref = nt.ops.fft.hartley_plain(x.double().cpu())
    assert _rel(full.double().cpu(), ref) <= 1e-5
    assert _rel(cfft.hartley2d(full) / x.numel(), x) <= 1e-5


@pytest.mark.parametrize("shape", [(768, 1280), (1792, 256), (1280, 1280), (256, 24576)])
def test_padded_pitch_round_trip(cuda_device, shape):
    """K3 writes the half spectrum with the padded pitch (padding zeroed),
    K4 reads it as it is, and H(H(x))/N = x."""
    n0, n1 = shape
    x = torch.randn(shape, device=cuda_device)
    G = cfft.hartley_rows(x)
    pitch = cfft.half_spectrum_pitch(n1)
    assert G.shape == (n0, n1 // 2 + 1) and G.stride() == (pitch, 1)
    assert not G.as_strided((n0, pitch), (pitch, 1))[:, n1 // 2 + 1 :].abs().any()
    H = cfft.hartley_cols(G, n1)
    assert _rel(H, cfft.hartley_cols_plain(cfft.hartley_rows_plain(x), n1)) <= 1e-5
    assert _rel(cfft.hartley2d(H) / x.numel(), x) <= 1e-5


def test_hartley_realigns_an_offset_input(cuda_device):
    """K3 loads 16-byte vectors; Hartley2d hands it an aligned copy of a
    contiguous input that starts off a 16-byte boundary."""
    n = 512
    x = torch.randn(n * n + 1, device=cuda_device)[1:].view(n, n)
    assert x.is_contiguous() and x.data_ptr() % 16
    with pytest.raises(ValueError):
        cfft.hartley_rows(x)
    native.reset_launches()
    H = nt.hartley(x)
    assert native.launches["hartley_rows"] == 1 and native.launches["hartley_cols"] == 1
    assert _rel(H.double().cpu(), nt.ops.fft.hartley_plain(x.double().cpu())) <= 1e-5


def test_hartley_dispatch_launches_kernels(cuda_device):
    x = torch.randn((512, 512), device=cuda_device)
    native.reset_launches()
    nt.hartley(x)
    assert native.launches["hartley_rows"] == 1 and native.launches["hartley_cols"] == 1
    native.reset_launches()
    nt.hartley(x.double())  # outside the kernel's domain: plain torch.fft
    assert not native.launches


def test_metric_on_card_matches_cpu_f64(cuda_device):
    n = 256
    cfm = nt.CorrelatedFieldMaker("cf")
    cfm.set_amplitude_total_offset(offset_mean=1.0, offset_std=(1e-1, 3e-2))
    cfm.add_fluctuations((n, n), 1.0 / n, (1.0, 5e-1), (-3.0, 2e-1), (1e0, 2e-1))
    cf = cfm.finalize()  # on the card, float32
    cf64 = cfm.finalize(device="cpu", dtype=torch.float64)
    assert all(b.device.type == "cuda" for b in cf.buffers())
    assert cf.amplitudes[0].mode_multiplicity.dtype == torch.float32
    assert cf64.amplitudes[0].mode_multiplicity.device.type == "cpu"
    rng = np.random.default_rng(0)
    pos = {k: rng.standard_normal(v.shape) for k, v in cf.domain.items()}
    tan = {k: rng.standard_normal(v.shape) for k, v in cf.domain.items()}
    data = rng.poisson(1.0, (n, n)).astype(np.int32)
    lh64 = nt.Poissonian(data, device="cpu").amend(nt.ChainModel(torch.exp, cf64))
    lh32 = nt.Poissonian(data).amend(nt.ChainModel(torch.exp, cf))
    assert lh32.likelihood.data.device.type == "cuda"
    p32 = nt.position_from_numpy(cf, pos)
    assert all(v.device.type == "cuda" and v.dtype == torch.float32 for v in p32.values())
    native.reset_launches()
    m32 = lh32.metric(p32, nt.position_from_numpy(cf, tan))
    for name in ("expand_to_grid", "collapse_from_grid", "hartley_rows", "hartley_cols"):
        assert native.launches[name] > 0, name
    m64 = lh64.metric(nt.position_from_numpy(cf64, pos), nt.position_from_numpy(cf64, tan))
    num = sum(float(((m32[k].double().cpu() - m64[k]) ** 2).sum()) for k in m64)
    den = sum(float((m64[k] ** 2).sum()) for k in m64)
    assert (num / den) ** 0.5 <= 1e-4


def test_batched_hartley_runs_the_kernel_pair_per_slice(cuda_device):
    """A (3, 1280, 1280) grid transformed over its trailing axes runs K3 and
    K4 once for the whole batch, not torch.fft, and equals the plain
    transform."""
    x = torch.randn((3, 1280, 1280), device=cuda_device)
    native.reset_launches()
    out = nt.hartley(x, axes=(1, 2))
    assert native.launches["hartley_rows"] == 1 and native.launches["hartley_cols"] == 1
    ref = nt.ops.fft.hartley_plain(x.double().cpu(), axes=(1, 2))
    assert _rel(out.double().cpu(), ref) <= 1e-5


@pytest.mark.parametrize("B", [1, 2, 4])
@pytest.mark.parametrize("shape", [(256, 512), (1024, 1024), (1280, 1280), (12288, 256)])
def test_batched_hartley_kernels(cuda_device, shape, B):
    """K3 over a (B, n0, n1) batch as B n0 rows and K4 with the batch in its
    launch grid (clusters, and the tile kernel for 12288 rows), against
    their plain versions; one launch each."""
    x = torch.randn((B,) + shape, device=cuda_device)
    native.reset_launches()
    G = cfft.hartley_rows(x)
    H = cfft.hartley_cols(G, shape[1])
    assert native.launches["hartley_rows"] == 1 and native.launches["hartley_cols"] == 1
    assert dict(native.batched_launches) == dict.fromkeys(["hartley_rows", "hartley_cols"], int(B > 1))
    Gp = cfft.hartley_rows_plain(x)
    assert _rel(G, Gp) <= 1e-5
    assert _rel(H, cfft.hartley_cols_plain(Gp, shape[1])) <= 1e-5
    assert _rel(cfft.hartley_cols(cfft.padded_half_spectrum(Gp), shape[1]), H) <= 1e-5


@pytest.mark.parametrize("B", [2, 4])
def test_vmap_rules_launch_once_per_batch(cuda_device, B):
    """Under ``torch.func.vmap`` K1 and K2 take the batch as their sample
    axis (B = 2 scalar, B = 4 16-byte vectors) and the Hartley pair as its
    leading batch: one launch of each kernel for B samples, and the plain
    versions' results (K1 exact; K2 and the Hartley to f32 rounding)."""
    full = (1280, 1280)
    index = grid_index(full).to(cuda_device)
    tab = torch.randn((B, index.n_unique), device=cuda_device)
    cot = torch.randn((B,) + full, device=cuda_device)
    native.reset_launches()
    grid = torch.func.vmap(lambda t: me.mode_expand_grid(t, index, full))(tab)
    seg = torch.func.vmap(lambda c: me.ModeCollapseGrid.apply(c, index, full))(cot)
    har = torch.func.vmap(nt.hartley)(cot)
    assert dict(native.launches) == {"expand_to_grid": 1, "collapse_from_grid": 1,
                                     "hartley_rows": 1, "hartley_cols": 1}
    assert native.batched_launches == native.launches
    for i in range(B):
        assert torch.equal(grid[i], ce.expand_to_grid_plain(tab[i], index, full))
        ref = ce.collapse_from_grid_plain(cot[i].double().cpu(), copy.deepcopy(index).to("cpu"), full)
        assert _rel(seg[i].double().cpu(), ref) <= 1e-6
        assert _rel(har[i], cfft.hartley_cols_plain(cfft.hartley_rows_plain(cot[i]), full[1])) <= 1e-5


def _rel_l2(got, ref):
    num = sum(float(((got[k].double().cpu() - ref[k]) ** 2).sum()) for k in ref)
    return (num / sum(float((ref[k] ** 2).sum()) for k in ref)) ** 0.5


def test_knot_metric_on_card_matches_cpu_f64(cuda_device):
    """The 64-knot Poisson metric at 256² on the card against float64 on
    the CPU; it runs K3/K4 and no table kernel."""
    lh32, pos, tan = build_likelihood(256, cuda_device, torch.float32, n_mode_knots=64)
    lh64, _, _ = build_likelihood(256, "cpu", torch.float64, n_mode_knots=64)
    native.reset_launches()
    m32 = lh32.metric(nt.position_from_numpy(lh32.forward_model, pos),
                      nt.position_from_numpy(lh32.forward_model, tan))
    torch.cuda.synchronize()
    assert native.launches["hartley_rows"] > 0 and native.launches["hartley_cols"] > 0
    assert native.launches["expand_to_grid"] == 0 and native.launches["collapse_from_grid"] == 0
    m64 = lh64.metric(nt.position_from_numpy(lh64.forward_model, pos),
                      nt.position_from_numpy(lh64.forward_model, tan))
    assert _rel_l2(m32, m64) <= 1e-4


def test_draw_linear_residual_on_card(cuda_device):
    """One MGVI residual of the 256² knot-64 VI model on the card, from an
    integer key: finite, on the card, through K3/K4."""
    lh, start = build_vi_likelihood(256, cuda_device, torch.float32, 64)
    pos = nt.position_from_numpy(lh.forward_model, start)
    native.reset_launches()
    res, info = nt.draw_linear_residual(lh, pos, 7, cg_kwargs=dict(maxiter=10))
    assert int(info) in range(0, 11)
    assert native.launches["hartley_rows"] > 0 and native.launches["hartley_cols"] > 0
    for k, v in res.items():
        assert v.device.type == "cuda" and v.shape == pos[k].shape and bool(torch.isfinite(v).all())


def test_vi_state_and_samples_pickle_on_card(cuda_device, tmp_path):
    """``optimize_kl(odir=...)`` pickles the samples and the state, whose key
    is a CUDA generator: one iteration at 256² knot-64 writes them (CPU
    tensors and the generator's state in the pickle, so it loads without a
    card), and ``io.load`` gives back tensors on the card and a generator
    in the same state."""
    import pickle

    lh, start = build_vi_likelihood(256, cuda_device, torch.float32, 64)
    pos = nt.position_from_numpy(lh.forward_model, start)
    key = torch.Generator(device=cuda_device).manual_seed(5)
    samples, state = nt.optimize_kl(
        lh, pos, key=key, n_total_iterations=1, n_samples=1, sample_mode="linear_resample",
        draw_linear_kwargs=dict(cg_kwargs=dict(maxiter=3)),
        kl_kwargs=dict(minimize_kwargs=dict(maxiter=1, cg_kwargs=dict(maxiter=3))),
        odir=str(tmp_path),
    )
    with open(tmp_path / "last.pkl", "rb") as f:
        raw, _ = pickle.load(f)
    assert all(v.device.type == "cpu" for v in raw.pos.values())
    s2, st2 = nt.io.load(str(tmp_path / "last.pkl"), device=cuda_device)
    assert st2.nit == 1 and st2.key.device.type == "cuda"
    assert torch.equal(st2.key.get_state(), key.get_state())
    assert all(v.device.type == "cuda" for v in s2.pos.values())
    assert torch.equal(s2._samples["cfxi"], samples._samples["cfxi"])


def _mcmc_model(n, device):
    """The exact n² Poisson model at counts of its own draw, on the card in
    float32, the same model in float64 on the CPU (the card's counts), and
    the latent that drew them."""
    from nifty_tpu_torch.bench.workload import bench_field, latent_draw

    lh, _ = build_vi_likelihood(n, device, torch.float32, None)
    lh64 = nt.Poissonian(lh.likelihood.data.cpu(), device="cpu").amend(
        nt.ChainModel(torch.exp, bench_field(n, "cpu", torch.float64, None)))
    return lh, lh64, latent_draw(lh.forward_model.domain, 0)


def test_batched_nuts_doubling_launches_once_per_batch(cuda_device):
    """At 256² exact, a batched gradient of 4 chains launches each of K1-K4
    as often as one chain's, all on the batch, and each chain's gradient is
    within relative L2 1e-4 of plain autograd in float64 on the CPU; one
    NUTS doubling (depth 2, 4 leaves) of the 4 chains runs K1-K4 on
    batches only."""
    from nifty_tpu_torch.hmc import QP, ChainDraws, Tree, iterative_build_tree
    from nifty_tpu_torch.hmc_oo import Potential, Ravel, kinetic_energy, make_stepper

    lh, lh64, truth = _mcmc_model(256, cuda_device)
    q = nt.position_from_numpy(lh.forward_model, truth)
    ravel = Ravel(q)
    potential = Potential(lambda x: -nt.LogDensity(lh)(x), ravel)
    x1 = ravel.ravel({k: v.unsqueeze(0) for k, v in q.items()})
    x4 = x1.repeat(4, 1) + 1e-3 * torch.randn((4, ravel.size), device=cuda_device)
    native.reset_launches()
    potential.gradient(x1)
    one = dict(native.launches)
    native.reset_launches()
    g4 = potential.gradient(x4)
    torch.cuda.synchronize()
    assert set(one) == set(native.launches) == {"expand_to_grid", "collapse_from_grid",
                                                "hartley_rows", "hartley_cols"}
    assert dict(native.launches) == one == dict(native.batched_launches)
    assert g4.shape == x4.shape and bool(torch.isfinite(g4).all())
    for c, g in enumerate(g4):
        q64 = {k: v.double().cpu().requires_grad_(True) for k, v in ravel.unravel(x4[c]).items()}
        g64 = torch.autograd.grad(-nt.LogDensity(lh64)(q64), list(q64.values()))
        ref = ravel.ravel({k: v.unsqueeze(0) for k, v in zip(q64, g64)})[0]
        assert float(torch.linalg.norm(g.double().cpu() - ref) / torch.linalg.norm(ref)) <= 1e-4
    p = torch.randn(x4.shape, device=cuda_device)
    inv_m = torch.ones_like(x4)
    neg_e = -(potential.energy(x4) + kinetic_energy(inv_m, p))
    no = torch.zeros(4, dtype=torch.bool, device=cuda_device)
    tree = Tree(QP(x4, p), QP(x4, p), neg_e, QP(x4, p), no, no,
                torch.full((4,), 2, device=cuda_device), torch.zeros_like(neg_e))
    native.reset_launches()
    sub = iterative_build_tree(ChainDraws([1, 2, 3, 4], cuda_device), tree, 1e-4, ~no,
                               make_stepper(potential), potential.energy, kinetic_energy, inv_m,
                               5, neg_e, 1000.0)
    torch.cuda.synchronize()
    assert dict(native.launches) == dict(native.batched_launches)
    assert all(native.launches[k] > 0 for k in one)
    assert bool(torch.isfinite(sub.proposal_candidate.position).all())


def test_leapfrog_energy_change_matches_cpu_f64(cuda_device):
    """ΔH over 8 leapfrog steps of the 256² posterior, 4 chains in one
    batch from near the latent that drew the counts: the card (float32
    field, float64 sums) within 0.1 nats of float64 on the CPU from the same
    q and p, each chain."""
    from nifty_tpu_torch.bench.workload import latent_draw, leapfrog_energy_change

    lh, lh64, truth = _mcmc_model(256, cuda_device)
    rng = np.random.default_rng(12)
    q = nt.position_from_numpy(lh.forward_model, {
        k: v[None] + 1e-2 * rng.standard_normal((4,) + v.shape) for k, v in truth.items()},
        batch=(4,))
    p = {k: torch.from_numpy(v).to(cuda_device, torch.float32)
         for k, v in latent_draw(q, 11).items()}
    dh32, _, _ = leapfrog_energy_change(lh, q, p, 2e-3, 8)
    to64 = lambda t: {k: v.double().cpu() for k, v in t.items()}  # noqa: E731
    dh64, _, _ = leapfrog_energy_change(lh64, to64(q), to64(p), 2e-3, 8)
    assert dh32.shape == (4,) and np.abs(dh32 - dh64).max() <= 0.1, (dh32, dh64)


def test_complex_gaussian_draw_on_card(cuda_device):
    """A complex ``Gaussian``'s data-space draw on the card is complex64,
    real and imaginary parts each of variance ½ (within five standard
    errors of 2¹⁶ draws)."""
    n = 1 << 16
    model = nt.Model(lambda x: x["x"].to(torch.complex64), domain={"x": nt.ShapeWithDtype((n,))})
    lh = nt.Gaussian(np.zeros(n, np.complex64)).amend(model)
    w = nt.white_noise(lh, {"x": torch.zeros(n, device=cuda_device)}, 5)
    assert w.data.dtype == torch.complex64 and w.data.device.type == "cuda"
    assert w.prior["x"].dtype == torch.float32
    for part in (w.data.real, w.data.imag):
        assert abs(float(part.var()) - 0.5) <= 5 * 0.5 * (2 / n) ** 0.5


def test_integrated_wiener_process_batch_accumulates_in_f64(cuda_device):
    """The amplitude's integrated Wiener process over the 1280² exact
    table (127,080 bins) for 4 excitations under ``torch.func.vmap`` in
    float32 on the card: within 2e-7 relative L2 of float64, as its two
    cumsums accumulate in float64."""
    from nifty_tpu_torch.models.gauss_markov import integrated_wiener_process

    rng = np.random.default_rng(3)
    n = 127_080
    xi = torch.from_numpy(rng.standard_normal((4, n, 2)))
    x0 = torch.tensor([0.3, -1.0], dtype=torch.float64)
    dt = torch.from_numpy(rng.uniform(1e-5, 1.1e-4, n))

    def iwp(x, x0, dt):
        return integrated_wiener_process(x, x0, torch.tensor(0.7, dtype=x.dtype), dt,
                                         torch.tensor(0.1, dtype=x.dtype))

    ref = torch.stack([iwp(x, x0, dt) for x in xi])
    f32 = lambda t: t.to(cuda_device, torch.float32)  # noqa: E731
    got = torch.func.vmap(lambda x: iwp(x, f32(x0), f32(dt)))(f32(xi)).double().cpu()
    assert float(torch.linalg.norm(got - ref) / torch.linalg.norm(ref)) <= 2e-7


def test_vmodel_metric_through_batched_kernels(cuda_device):
    """A ``VModel`` of 4 exact 1280² fields (every key mapped) under
    ``Poissonian``: its metric runs K1-K4 on a batch of 4 and equals 4
    separate applies on the card within 1e-5 (f32 on both sides), and the
    batch's metric in float64 on the CPU (plain kernel versions) within
    1e-4."""
    n, B = 1280, 4
    cf, cf64 = (build_likelihood(n, d, t)[0].forward_model.inner
                for d, t in ((cuda_device, torch.float32), ("cpu", torch.float64)))
    vm, vm64 = nt.VModel(cf, B), nt.VModel(cf64, B)
    rng = np.random.default_rng(4)
    counts = rng.poisson(1.0, (B, n, n)).astype(np.int32)
    pos = {k: rng.standard_normal(v.shape) for k, v in vm.domain.items()}
    tan = {k: rng.standard_normal(v.shape) for k, v in vm.domain.items()}
    lh = nt.Poissonian(counts).amend(nt.ChainModel(torch.exp, vm))
    p, t = nt.position_from_numpy(vm, pos), nt.position_from_numpy(vm, tan)
    native.reset_launches()
    m = lh.metric(p, t)
    torch.cuda.synchronize()
    assert native.batched_launches == native.launches and len(native.launches) == 4
    parts = [nt.Poissonian(counts[i]).amend(nt.ChainModel(torch.exp, cf)).metric(
        {k: v[i] for k, v in p.items()}, {k: v[i] for k, v in t.items()}) for i in range(B)]
    sep = {k: torch.stack([q[k] for q in parts]).double().cpu() for k in m}
    assert _rel_l2(m, sep) <= 1e-5
    m64 = nt.Poissonian(counts, device="cpu").amend(nt.ChainModel(torch.exp, vm64)).metric(
        nt.position_from_numpy(vm64, pos), nt.position_from_numpy(vm64, tan))
    assert _rel_l2(m, m64) <= 1e-4


def test_daleckii_krein_on_card_matches_cpu(cuda_device):
    """``sym_sqrtm``/``sym_logm``/``sym_inv`` of 1280² stacked SPD 2×2
    matrices on the card (batched ``eigh``): values, jvps and pull-backs
    within 1e-4 of float64 on the CPU (f32 eigensystems), the outputs on
    the card."""
    rng = np.random.default_rng(5)
    m = rng.standard_normal((1280, 1280, 2, 2))
    M = m @ np.swapaxes(m, -1, -2) + 0.5 * np.eye(2)
    dM = rng.standard_normal(M.shape)
    dM = dM + np.swapaxes(dM, -1, -2)
    Mc, dMc = (torch.from_numpy(a).to(cuda_device, torch.float32) for a in (M, dM))
    for fn in (nt.sym_sqrtm, nt.sym_logm, nt.sym_inv):
        y, dy = torch.func.jvp(fn, (Mc,), (dMc,))
        g = torch.func.vjp(fn, Mc)[1](dMc)[0]
        y64, dy64 = torch.func.jvp(fn, (torch.from_numpy(M),), (torch.from_numpy(dM),))
        g64 = torch.func.vjp(fn, torch.from_numpy(M))[1](torch.from_numpy(dM))[0]
        for got, want in ((y, y64), (dy, dy64), (g, g64)):
            assert got.device.type == "cuda"
            assert _rel(got.double().cpu(), want) <= 1e-4, fn.__name__


def test_interpolant_on_card(cuda_device):
    """A tabulated prior's interpolant on the card: float64 tables on the
    card, an f32 result within 1e-6 of CPU float64."""
    ip = nt.invgamma_prior(3.0, 2.0).to(cuda_device)
    assert ip.xs.device.type == "cuda" and ip.xs.dtype == torch.float64
    x = torch.randn((512, 512), device=cuda_device)
    y = ip(x)
    assert y.device.type == "cuda" and y.dtype == torch.float32
    assert _rel(y.double().cpu(), nt.invgamma_prior(3.0, 2.0)(x.double().cpu())) <= 1e-6


def test_los_pull_back_is_deterministic_on_card(cuda_device):
    """``ExactGridLOS`` at 512² with 4,096 rays: its pull-back (the
    gather-reduce's transpose, no float atomics) gives the same bits on two
    calls, also under ``torch.func.vmap``; its forward within 1e-5 of
    float64 on the CPU."""
    rng = np.random.default_rng(41)
    n, r = 512, 4096
    starts = np.stack([np.zeros(r), rng.uniform(size=r)], 1)
    ends = np.stack([np.ones(r), rng.uniform(size=r)], 1)
    kw = dict(shape=(n, n), distances=1.0 / n)
    los = nt.ExactGridLOS(starts, ends, **kw)
    los64 = nt.ExactGridLOS(starts, ends, **kw, device="cpu", dtype=torch.float64)
    x = torch.rand((n, n), device=cuda_device)
    c = torch.randn((3, r), device=cuda_device)
    _, pull = torch.func.vjp(los, x)
    assert torch.equal(pull(c[0])[0], pull(c[0])[0])
    batched = lambda: torch.func.vmap(lambda v: pull(v)[0])(c)  # noqa: E731
    assert torch.equal(batched(), batched())
    assert _rel(los(x).double().cpu(), los64(x.double().cpu())) <= 1e-5


def test_no_host_transfers_raises_on_a_sync(cuda_device):
    from nifty_tpu_torch.extra import check_no_host_transfers, no_host_transfers

    x = torch.ones(4, device=cuda_device)
    with pytest.raises(RuntimeError):
        with no_host_transfers():
            x.sum().item()
    assert torch.cuda.get_sync_debug_mode() == 0  # restored
    out = check_no_host_transfers(lambda v: v * 2, x)
    assert out.device.type == "cuda"


def test_nufft2_on_card_matches_cpu(cuda_device):
    """``nufft2`` of a 256² complex image at 4,096 points, complex64 on the
    card against complex128 on the CPU: within 1e-5 of the maximum."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((256, 256)) + 1j * rng.standard_normal((256, 256))
    coords = rng.uniform(-0.5, 0.5, (2, 4096))
    got = nt.nufft2(torch.from_numpy(x).to(cuda_device, torch.complex64),
                    torch.from_numpy(coords).to(cuda_device, torch.float32))
    ref = nt.nufft2(torch.from_numpy(x), torch.from_numpy(coords.astype(np.float32)).double())
    assert got.device.type == "cuda" and got.dtype == torch.complex64
    assert _rel(got.cpu().to(torch.complex128), ref) <= 1e-5


# --- K5/K6: the Legendre contraction of the spherical-harmonic synthesis


def _legendre_plan(kind):
    from nifty_tpu_torch.ops import cuda_legendre as cl
    from nifty_tpu_torch.ops import sht

    if kind == "healpix_64":
        z, lmax, mmax = sht.healpix_ring_geometry(64)[0], 128, 128
    elif kind == "healpix_64_lmax96":  # the analysis' plan in chip_smoke.py
        z, lmax, mmax = sht.healpix_ring_geometry(64)[0], 96, 96
    elif kind == "healpix_16_mmax":
        z, lmax, mmax = sht.healpix_ring_geometry(16)[0], 32, 20
    elif kind == "healpix_256_lmax64":  # 512 northern rings: one K6 block on the CUDA cores
        z, lmax, mmax = sht.healpix_ring_geometry(256)[0], 64, 64
    elif kind == "healpix_512_lmax64":  # 1,024 northern rings: 2 chunks on the tensor cores
        z, lmax, mmax = sht.healpix_ring_geometry(512)[0], 64, 64
    elif kind == "healpix_1024_lmax16":  # 2,048 northern rings: 2 chunks on the CUDA cores
        z, lmax, mmax = sht.healpix_ring_geometry(1024)[0], 16, 16
    else:  # an odd lmax: an even ring count, no equator ring
        z, lmax, mmax = sht.gauss_legendre_grid(63)[0], 63, 63
    return cl.LegendrePlan(z, lmax, mmax)


@pytest.mark.parametrize("kind,B", [(kind, B) for kind in ("healpix_64", "healpix_64_lmax96",
                                                             "healpix_16_mmax", "gauss_legendre_63")
                                     for B in (1, 2, 3, 4, 5, 8, 16)]
                         + [("healpix_256_lmax64", B) for B in (1, 4, 8, 16)]
                         + [("healpix_512_lmax64", 8), ("healpix_1024_lmax16", 1)]
                         + [("healpix_64", 256)])
def test_legendre_kernels_match_plain(cuda_device, kind, B):
    """K5 and K6 in float32 against their plain versions in float64 on the
    CPU: max|Δ| <= 1e-5 max|ref| (float32 sums over up to lmax + 1 terms);
    K6 the same bits twice.  The batches of 3 and 5 take the 4-sample
    CUDA-core kernels with a partial group; 8 and 16, the smallest batches
    on the tensor cores (``cl.MMA_MIN_BATCH``), and 256 (a sphere times a
    regular 256 axis) the tensor-core kernels, 8 samples a block; nside 256
    at lmax 64 has 512 northern rings, all in one K6 block (more than one
    chunk of the previous design's 256).  Nside 512 at B = 8 (1,024 northern
    rings on the tensor cores) and nside 1024 at B = 1 (2,048 on the CUDA
    cores) take two ring chunks, summed by K6's second launch
    (``chunk_sum_kernel``), which the launch counter counts."""
    from nifty_tpu_torch.ops import cuda_legendre as cl

    plan = _legendre_plan(kind)
    plan_d = copy.deepcopy(plan).to(cuda_device)
    g = torch.Generator(device=cuda_device).manual_seed(B)
    alm = torch.randn((B, plan.size), generator=g, device=cuda_device)
    n0 = native.launches["legendre_contract"]
    out = cl.legendre_contract(alm, plan_d)
    assert native.launches["legendre_contract"] == n0 + 1
    assert _rel(out.double().cpu(), cl.legendre_contract_plain(alm.double().cpu(), plan)) <= 1e-5
    cot = torch.randn((B, plan.n_rings, plan.mmax + 1, 2), generator=g, device=cuda_device)
    n0 = native.launches["legendre_contract_t"]
    back = cl.legendre_contract_t(cot, plan_d)
    chunks = cl.launch_config(plan, B, transpose=True).n_chunks
    assert native.launches["legendre_contract_t"] == n0 + (2 if chunks > 1 else 1)
    assert chunks > 1 or kind not in ("healpix_512_lmax64", "healpix_1024_lmax16")
    assert torch.equal(back, cl.legendre_contract_t(cot, plan_d))
    assert _rel(back.double().cpu(), cl.legendre_contract_t_plain(cot.double().cpu(), plan)) <= 1e-5


def test_legendre_kernels_take_any_float_offset(cuda_device):
    """The kernels stage their columns by 16-byte bulk copies and the words
    around them: inputs 1-3 floats off a 16-byte boundary give the bits of
    an aligned copy."""
    from nifty_tpu_torch.ops import cuda_legendre as cl

    plan = copy.deepcopy(_legendre_plan("healpix_16_mmax")).to(cuda_device)
    g = torch.Generator(device=cuda_device).manual_seed(7)
    for B in (1, 3, 8):
        n5, n6 = B * plan.size, B * plan.n_rings * (plan.mmax + 1) * 2
        a_buf = torch.randn(n5 + 3, generator=g, device=cuda_device)
        c_buf = torch.randn(n6 + 3, generator=g, device=cuda_device)
        for k in (1, 2, 3):
            alm = a_buf[k:k + n5].view(B, plan.size)
            cot = c_buf[k:k + n6].view(B, plan.n_rings, plan.mmax + 1, 2)
            assert alm.data_ptr() % 16 and cot.data_ptr() % 16
            assert torch.equal(cl.legendre_contract(alm, plan), cl.legendre_contract(alm.clone(), plan))
            assert torch.equal(cl.legendre_contract_t(cot, plan),
                               cl.legendre_contract_t(cot.clone(), plan))


def test_legendre_wrappers_raise_on_bad_cuda_input(cuda_device):
    from nifty_tpu_torch.ops import cuda_legendre as cl

    plan = copy.deepcopy(_legendre_plan("healpix_16_mmax")).to(cuda_device)
    good = torch.zeros((2, plan.size), device=cuda_device)
    for bad, exc in ((good.double(), TypeError), (good[:, :-1], ValueError),
                     (good.t().contiguous().t(), ValueError)):
        with pytest.raises(exc):
            cl.legendre_contract(bad, plan)
    with pytest.raises(ValueError):
        cl.legendre_contract_t(torch.zeros((2, plan.n_rings, plan.mmax, 2), device=cuda_device), plan)


def test_healpix_synthesis_on_card_matches_cpu_f64(cuda_device):
    """The synthesis at nside 32 and its pull-back (K5, K6) against float64
    on the CPU, 1e-5 of the maximum; a vmapped batch of 3 is one launch of
    each kernel."""
    from nifty_tpu_torch.ops import sht

    synth64 = sht.HealpixSynthesis(32)
    synth = copy.deepcopy(synth64).to(cuda_device, torch.float32)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, synth.size))
    y = rng.standard_normal((3, synth.npix))
    xd = torch.from_numpy(x).to(cuda_device, torch.float32)
    yd = torch.from_numpy(y).to(cuda_device, torch.float32)
    native.reset_launches()
    out, pull = torch.func.vjp(torch.func.vmap(synth), xd)
    back = pull(yd)[0]
    assert native.launches["legendre_contract"] == native.launches["legendre_contract_t"] == 1
    assert native.batched_launches["legendre_contract_t"] == 1
    ref, pull64 = torch.func.vjp(torch.func.vmap(synth64), torch.from_numpy(x))
    assert _rel(out.double().cpu(), ref) <= 1e-5
    assert _rel(back.double().cpu(), pull64(torch.from_numpy(y))[0]) <= 1e-5


def test_spherical_metric_on_card_matches_cpu_f64(cuda_device):
    """The spherical correlated field at nside 16 under a Gaussian: the
    metric through K1, K2 (the flat 1-D layout), K5 and K6, against float64
    on the CPU (1e-4)."""
    def sky(**kw):
        cfm = nt.CorrelatedFieldMaker("sky")
        cfm.set_amplitude_total_offset(offset_mean=0.0, offset_std=(1e-1, 3e-2))
        cfm.add_fluctuations((16,), distances=None, fluctuations=(1.0, 0.5),
                             loglogavgslope=(-3.0, 0.5), flexibility=(1.0, 0.3),
                             harmonic_type="spherical")
        return cfm.finalize(**kw)

    cf, cf64 = sky(), sky(device="cpu", dtype=torch.float64)
    rng = np.random.default_rng(1)
    pos = {k: 0.5 * rng.standard_normal(v.shape) for k, v in cf.domain.items()}
    tan = {k: rng.standard_normal(v.shape) for k, v in cf.domain.items()}
    data = rng.standard_normal(12 * 16**2)
    lh = nt.Gaussian(torch.from_numpy(data).to(cuda_device, torch.float32),
                     noise_cov_inv=lambda x: x / 0.04).amend(cf)
    lh64 = nt.Gaussian(torch.from_numpy(data), noise_cov_inv=lambda x: x / 0.04).amend(cf64)
    native.reset_launches()
    m = lh.metric(nt.position_from_numpy(cf, pos), nt.position_from_numpy(cf, tan))
    for k in ("expand_to_grid", "collapse_from_grid", "legendre_contract", "legendre_contract_t"):
        assert native.launches[k] >= 1, k
    ref = lh64.metric(nt.position_from_numpy(cf64, pos), nt.position_from_numpy(cf64, tan))
    num = sum(float(((m[k].double().cpu() - ref[k]) ** 2).sum()) for k in ref)
    assert (num / sum(float((ref[k] ** 2).sum()) for k in ref)) ** 0.5 <= 1e-4


def test_icr_field_on_card_matches_cpu_f64(cuda_device):
    """A learned-Matérn ICR field on a 2-D open grid (the uniform levels as
    convolutions, cuDNN's TF32 left on by the process): the forward on the
    card within 1e-5 of float64 on the CPU."""
    from nifty_tpu_torch import multi_grid as tm

    def field(**kw):
        matern = tm.MaternCovarianceModel(ndim=2, r_min=0.05, r_max=20.0, scale=(1.0, 0.3),
                                          cutoff=(2.0, 0.5), loglogslope=(-3.5, 0.5))
        return tm.ICRField(tm.SimpleOpenGrid(shape0=(16, 16), depth=3, padding=1), matern, **kw)

    f, f64 = field(), field(device="cpu", dtype=torch.float64)
    rng = np.random.default_rng(2)
    pos = {k: [rng.standard_normal(s.shape) for s in v] if isinstance(v, list)
           else rng.standard_normal(v.shape) for k, v in f.domain.items()}
    torch.backends.cudnn.allow_tf32 = True
    try:
        out = f(nt.position_from_numpy(f, pos))
    finally:
        torch.backends.cudnn.allow_tf32 = False
    ref = f64(nt.position_from_numpy(f64, pos))
    assert out.device.type == "cuda" and _rel(out.double().cpu(), ref) <= 1e-5


# --- the diagnostics and the output on the card


def test_empirical_power_spectrum_on_card(cuda_device):
    """The spectrum of a 1280² float32 field on the card: the same bits on
    two calls (the shells summed in a fixed order), within 1e-5 of the
    maximum of the same spectrum in float64 on the CPU."""
    x = torch.from_numpy(np.random.default_rng(5).standard_normal((1280, 1280)))
    xd = x.to(cuda_device, torch.float32)
    ps, k = nt.compute_empirical_power_spectrum(xd, distances=1.0 / 1280, n_bins=128)
    assert ps.device.type == "cuda" and k.device.type == "cuda"
    assert torch.equal(ps, nt.compute_empirical_power_spectrum(xd, distances=1.0 / 1280, n_bins=128)[0])
    ref, _ = nt.compute_empirical_power_spectrum(xd.double().cpu(), distances=1.0 / 1280, n_bins=128)
    assert _rel(ps.double().cpu(), ref) <= 1e-5


def test_card_checkpoint_loads_on_the_cpu(cuda_device, tmp_path):
    """An ``optimize_kl`` checkpoint written from the card (its generator on
    the card) loads with ``device="cpu"``: the same values, CPU tensors."""
    cf = bench_field(256, cuda_device, torch.float32)
    rng = np.random.default_rng(6)
    pos = nt.position_from_numpy(cf, {k: rng.standard_normal(v.shape) for k, v in cf.domain.items()})
    data = torch.from_numpy(rng.standard_normal((256, 256))).to(cuda_device, torch.float32)
    lh = nt.Gaussian(data, noise_cov_inv=1.0).amend(cf)
    samples, _ = nt.optimize_kl(lh, pos, key=torch.Generator(device=cuda_device).manual_seed(1),
                                n_total_iterations=1, n_samples=1, sample_mode="linear_resample",
                                draw_linear_kwargs=dict(cg_kwargs=dict(maxiter=5)),
                                kl_kwargs=dict(minimize_kwargs=dict(maxiter=2)), odir=str(tmp_path))
    back = nt.io.load_samples(str(tmp_path / "last.pkl"), device="cpu")
    for k in samples.pos:
        assert back.pos[k].device.type == "cpu"
        assert torch.equal(back.pos[k], samples.pos[k].cpu())
        assert torch.equal(back._samples[k], samples._samples[k].cpu())
    _, state = nt.io.load(str(tmp_path / "last.pkl"), device="cpu")
    assert state.key.device.type == "cpu"


def test_check_model_device_times(cuda_device):
    """``check_model`` of a 1280² field on the card: every mode's eager and
    device time and peak memory positive."""
    cf = bench_field(1280, cuda_device, torch.float32)
    rng = np.random.default_rng(7)
    pos = nt.position_from_numpy(cf, {k: rng.standard_normal(v.shape) for k, v in cf.domain.items()})
    report = nt.check_model(cf, pos, log=lambda msg: None)
    assert set(report) == {"forward", "jvp", "vjp"}
    for r in report.values():
        assert r["time_raw"] > 0 and r["device_ms"] > 0 and r["peak_bytes"] > 0


# --- the range forms of the multi-GPU slice: K1r, K2r, K4r ------------------------------


def _check_row_range(index_d, full, rows, tab, cot, grid):
    """K1r on ``rows`` bit-exact against K1's rows ``grid``; K2r of those
    rows of ``cot`` the same bits twice and within 1e-6 of float64 (its
    plain version on the card); returns K2r's part in float64."""
    lo, n = rows
    assert torch.equal(ce.expand_to_grid_rows(tab, index_d, full, rows), grid[lo:lo + n])
    cot_r = cot[lo:lo + n].clone()  # a fresh, aligned buffer
    part = ce.collapse_from_grid_rows(cot_r, index_d, full, rows)
    assert torch.equal(part, ce.collapse_from_grid_rows(cot_r, index_d, full, rows))
    assert _rel(part.double(), ce.collapse_from_grid_rows_plain(cot_r.double(), index_d, full, rows)) <= 1e-6
    return part.double()


def _tab_and_cot(index, full, B, dev):
    batch = () if B == 1 else (B,)
    g = torch.Generator(device=dev).manual_seed(B)
    return (torch.randn((index.n_unique,) + batch, device=dev, generator=g),
            torch.randn(tuple(full) + batch, device=dev, generator=g))


@pytest.mark.parametrize("n", [1280, 4096])
@pytest.mark.parametrize("p", [2, 4, 8])
def test_row_range_kernels_match_plain(cuda_device, n, p):
    """K1r on each of p ranks' rows is K1's rows (bit-exact), K2r's partial
    tables are the same bits twice and sum to K2's (relative 1e-6 of
    float64), at B = 1, 2, 3 and 4; K1 and K2 on the full grid match their
    plain versions."""
    full = (n, n)
    index_d = copy.deepcopy(grid_index(full)).to(cuda_device)
    b = n // p
    for B in (1, 2, 3, 4):
        tab, cot = _tab_and_cot(index_d, full, B, cuda_device)
        grid = ce.expand_to_grid(tab, index_d, full)
        assert torch.equal(grid, ce.expand_to_grid_plain(tab, index_d, full))
        k2 = ce.collapse_from_grid_plain(cot.double(), index_d, full)
        assert _rel(ce.collapse_from_grid(cot, index_d, full).double(), k2) <= 1e-6
        parts = sum(_check_row_range(index_d, full, (r * b, b), tab, cot, grid) for r in range(p))
        assert _rel(parts, k2) <= 1e-6


ROW_RANGE_CASES = {  # grid: the ranges of its leading axis
    (4096, 4096): [(2048, 2), (2047, 2), (5, 1), (4095, 1), (3000, 700), (2049, 2047)],  # rfp2
    (1280, 1280): [(640, 2), (640, 1), (1000, 280), (600, 100), (0, 1280)],  # H = 641
    (1281, 1281): [(640, 2), (641, 640), (7, 300)],  # odd n: runs of one point
    (1282, 1282): [(641, 2), (0, 1), (700, 582)],  # flat 2-D: H even
    (64, 48, 40): [(32, 2), (20, 24), (40, 24), (63, 1), (0, 64)],  # flat 3-D, the range on axis 0
}


@pytest.mark.parametrize("full", sorted(ROW_RANGE_CASES))
def test_row_range_kernels_on_edge_ranges(cuda_device, full):
    """K1r and K2r on ranges at the mirror's edge (rows n/2 and n/2 + 1),
    of one row, only in the mirrored half, on 1280² (H = 641, no multiple
    of 32), an odd grid, the flat layouts (2-D, and 3-D with the range on
    axis 0), at B = 1, 2, 3 and 4: as ``_check_row_range``."""
    index_d = copy.deepcopy(grid_index(full)).to(cuda_device)
    for B in (1, 2, 3, 4):
        tab, cot = _tab_and_cot(index_d, full, B, cuda_device)
        grid = ce.expand_to_grid(tab, index_d, full)
        assert torch.equal(grid, ce.expand_to_grid_plain(tab, index_d, full))
        for rows in ROW_RANGE_CASES[full]:
            _check_row_range(index_d, full, rows, tab, cot, grid)


def test_row_range_wrappers_refuse_a_1d_grid(cuda_device):
    """K1r and K2r take a row range on a grid of 2 or 3 axes only."""
    index, full = _index(1000, 100, 1)
    index_d = copy.deepcopy(index).to(cuda_device)
    with pytest.raises(ValueError, match="2 or 3 axes"):
        ce.expand_to_grid_rows(torch.zeros(100, device=cuda_device), index_d, full, (0, 10))
    with pytest.raises(ValueError, match="2 or 3 axes"):
        ce.collapse_from_grid_rows(torch.zeros(10, device=cuda_device), index_d, full, (0, 10))


@pytest.mark.parametrize("rows", [320, 2, 1030])
def test_row_kernel_takes_a_rank_s_rows(cuda_device, rows):
    """K3 on any even number of rows (a rank's rows of 1280² over 4 ranks:
    320), alone and in a batch of 2."""
    for shape in ((rows, 1280), (2, rows, 1280)):
        x = torch.randn(shape, device=cuda_device)
        assert _rel(cfft.hartley_rows(x), cfft.hartley_rows_plain(x)) <= 1e-5


@pytest.mark.parametrize("shape", [(1280, 1280), (4096, 4096), (12288, 256)])
@pytest.mark.parametrize("p", [2, 4, 8])
def test_column_range_kernel_matches_plain(cuda_device, shape, p):
    """K4r on each rank's column block of the half spectrum, its halo the
    next block's first column (the last rank's the Nyquist column), against
    its plain version, at B = 1 and 2; clusters and (12288 rows) the
    two-column tiles."""
    n0, n1 = shape
    w = n1 // (2 * p)
    for B in (1, 2):
        x = torch.randn((B, n0, n1) if B > 1 else (n0, n1), device=cuda_device)
        G = cfft.hartley_rows(x)
        for r in range(p):
            P = cfft.hartley_cols_range(G, w, r * w)
            Pp = cfft.hartley_cols_range_plain(G[..., r * w:], w)
            assert P.shape == Pp.shape and _rel(P, Pp) <= 1e-5
    assert native.launches["hartley_cols_range"] >= 2 * p


def _exchange_buffer(G, p, r, w):
    """Rank r's receive buffer of the pencil Hartley's first exchange: from
    each of the p senders its rows of the half spectra ``G`` (``(B, n0,
    h)``), columns r w .. r w + w + 7, sender-major ``(p, B, n0/p, w + 8)``."""
    rows = G.shape[-2] // p
    pitch = G.stride(-2)
    Gp = torch.as_strided(G, tuple(G.shape[:-1]) + (pitch,), G.stride(), G.storage_offset())
    return torch.stack([Gp[:, s * rows:(s + 1) * rows, r * w:r * w + w + 8] for s in range(p)])


@pytest.mark.parametrize("B", [1, 2, 3])
@pytest.mark.parametrize("shape", [(1280, 1280), (4096, 4096), (12288, 256)])
@pytest.mark.parametrize("p", [2, 4, 8])
def test_column_range_kernel_on_the_exchange_layout(cuda_device, shape, p, B):
    """K4r reading each rank's block where the receive buffer holds it,
    sender-major ``(p, B, n0/p, w + 8)``, and writing the return exchange's
    send buffer ``(p, B, n0/p, 2w)``: within 1e-5 of its plain version on
    the same layout, and the same bits as K4r on the joined block (the
    same launch shape, so the same arithmetic), rows cut destination-major."""
    n0, n1 = shape
    w, rows = n1 // (2 * p), n0 // p
    G = cfft.hartley_rows(torch.randn((B, n0, n1), device=cuda_device))
    native.reset_launches()
    for r in range(p):
        buf = _exchange_buffer(G, p, r, w)
        P = cfft.hartley_cols_range(buf, w, n1=n1)
        Pp = cfft.hartley_cols_range_plain(buf, w)
        assert P.shape == Pp.shape == (p, B, rows, 2 * w) and _rel(P, Pp) <= 1e-5
        joined = cfft.hartley_cols_range(G, w, r * w)  # (B, n0, 2w)
        assert torch.equal(P, joined.reshape(B, p, rows, 2 * w).movedim(1, 0))
    assert native.launches["hartley_cols_range"] == 2 * p
    assert native.batched_launches["hartley_cols_range"] == (2 * p if B > 1 else 0)


@pytest.mark.parametrize("p", [1, 2])
def test_pencil_stages_on_card(cuda_device, p):
    """The 2-D pencil stages with K3 + K4r on the card composed over p
    virtual ranks against ``hartley2d``, at B = 1 and 2; one rank hands
    stage 1's buffer to stage 2 as it is (an exchange with itself: the
    buffer is a view of K3's padded rows)."""
    from nifty_tpu_torch.parallel.fft import pencil_stages

    n = 1024
    rows, cols, place = pencil_stages((n, n), p, torch.float32)
    b = n // p
    for B in (1, 2):
        x = torch.randn((B, n, n), device=cuda_device)
        sent = [rows(x[:, r * b:(r + 1) * b]) for r in range(p)]
        recv = [sent[0] if p == 1 else torch.stack([sent[r][s] for r in range(p)]) for s in range(p)]
        packed = [cols(recv[s], s) for s in range(p)]
        got = torch.cat([place(torch.stack([packed[s][r] for s in range(p)]), r) for r in range(p)], dim=1)
        assert _rel(got, cfft.hartley2d(x)) <= 1e-5


@pytest.mark.parametrize("case", [(4096, 2), (4096, 8), (1280, 4), (10240, 4)])
def test_column_range_launch_shapes(cuda_device, case):
    """Every K4r launch shape that fits (clusters of 2, 4, 8 and 16 blocks,
    8 to 64 threads a column) on the exchange's layout against the plain
    version; ``range_launch`` picks one of them."""
    n, p = case
    w, rows = n // (2 * p), n // p
    buf = torch.randn((p, 1, rows, w + 8), dtype=torch.complex64, device=cuda_device)
    ref = cfft.hartley_cols_range_plain(buf, w)
    H = torch.empty_like(ref)
    shapes = [(T, parts) for parts in cfft.CLUSTERS for T in (8, 16, 32, 64)
              if cfft._cluster_fits(n, parts, T)]
    assert max(parts for _, parts in shapes) >= 8
    for T, parts in shapes:
        H.fill_(float("nan"))
        cfft._launch_cols(buf, H, T, 8, parts, n1=n, n_cols=w)
        assert _rel(H, ref) <= 1e-5, (T, parts)
    T, tc, parts = cfft.range_launch(n, w)
    assert tc == 8 and cfft._cluster_fits(n, parts, T)


def test_reduce_scatter_vmap_rule_on_one_rank(cuda_device, tmp_path):
    """The reduce-scatter Function on a one-rank NCCL group: under
    ``torch.func.vmap`` a batch is one collective along the mapped axis's
    neighbour, its adjoint (the all-gather) by ``vjp``, its jvp itself."""
    import torch.distributed as dist

    from nifty_tpu_torch import parallel
    from nifty_tpu_torch.parallel.collectives import all_gather, reduce_scatter

    parallel.initialize(str(tmp_path / "store"), 1, 0)
    try:
        group = dist.group.WORLD
        x = torch.randn(3, 8, 5, device=cuda_device)
        fn = lambda v: reduce_scatter(v, group) * 2.0  # noqa: E731
        assert torch.equal(torch.func.vmap(fn)(x), 2.0 * x)
        assert torch.equal(torch.func.vmap(fn, in_dims=1, out_dims=1)(x.movedim(0, 1)),
                           2.0 * x.movedim(0, 1))
        y, pull = torch.func.vjp(fn, x[0])
        assert torch.equal(pull(torch.ones_like(y))[0], torch.full_like(x[0], 2.0))
        _, tan = torch.func.jvp(fn, (x[0],), (x[1],))
        assert torch.equal(tan, 2.0 * x[1])
        assert torch.equal(torch.func.vmap(lambda v: all_gather(v, group, axis=-1))(x), x)
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("start, n", [(0, 1 << 20), (3, 100003), (4096 * 1024, 4096 * 256),
                                      (1, 2049), (4099, 12345), (2 * 256 * 4 - 2, 2 * 256 * 4 + 5),
                                      (2**34 - 6, 20), (2**34 + 3, 100003), (2**40 + 8, 1 << 18)])
def test_philox_normal_matches_plain(cuda_device, start, n):
    """K7 against its plain version on the card: the Philox words the same
    bits, the f32 normals within 1e-6 of the maximum (the kernel's f32
    ``logf``/``sincospif`` against the plain float64 Box-Muller rounded
    once), the f64 ones within 1e-12; a range alone is that range of a
    longer draw, bit for bit; one count a launch."""
    from nifty_tpu_torch.ops import cuda_normal as cn

    native.reset_launches()
    assert torch.equal(cn.philox_words(2**50 + 9, 4, start, n, cuda_device),
                       cn.philox_words_plain(2**50 + 9, 4, start, n, cuda_device))
    for dt, tol in ((torch.float32, 1e-6), (torch.float64, 1e-12)):
        z = cn.philox_normal(2**50 + 9, 4, start, n, dt, cuda_device)
        zp = cn.philox_normal_plain(2**50 + 9, 4, start, n, dt, cuda_device)
        assert z.dtype == dt and z.shape == (n,) and _rel(z, zp) <= tol
        longer = cn.philox_normal(2**50 + 9, 4, start - start % 4, n + 8, dt, cuda_device)
        assert torch.equal(longer[start % 4:start % 4 + n], z)
    assert native.launches["philox_normal"] == 4


def test_philox_ranges_are_the_whole_draw_on_card(cuda_device):
    """K7: every rank's rows of a 4096 x 64 leaf over 2, 4 and 8 ranks, an
    unaligned range at 4099 and ranges into an output off a 16-byte
    boundary's group (the unaligned instantiation) are the whole draw's
    entries, bit for bit, in f32 and f64."""
    from nifty_tpu_torch.ops import cuda_normal as cn

    key, leaf, m = 2**61 + 12345, 3, 64
    for dt in (torch.float32, torch.float64):
        whole = cn.philox_normal(key, leaf, 0, 4096 * m, dt, cuda_device)
        for p in (2, 4, 8):
            b = 4096 // p
            for r in range(p):
                got = cn.philox_normal(key, leaf, r * b * m, b * m, dt, cuda_device)
                assert torch.equal(got, whole[r * b * m:(r + 1) * b * m])
        for start, n in ((4099, 12345), (1, 7), (2, 1026), (4093, 4 * 256 * 2 + 11)):
            assert torch.equal(cn.philox_normal(key, leaf, start, n, dt, cuda_device),
                               whole[start:start + n])
