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
from nifty_tpu_torch.bench.workload import build_likelihood, build_vi_likelihood, grid_index
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
    K4 once per slice, not torch.fft, and equals the plain transform."""
    x = torch.randn((3, 1280, 1280), device=cuda_device)
    native.reset_launches()
    out = nt.hartley(x, axes=(1, 2))
    assert native.launches["hartley_rows"] == 3 and native.launches["hartley_cols"] == 3
    ref = nt.ops.fft.hartley_plain(x.double().cpu(), axes=(1, 2))
    assert _rel(out.double().cpu(), ref) <= 1e-5


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
    is a CUDA generator: one iteration at 256² knot-64 writes them, and the
    pickle gives back tensors on the card and a generator in the same
    state."""
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
        s2, st2 = pickle.load(f)
    assert st2.nit == 1 and st2.key.device.type == "cuda"
    assert torch.equal(st2.key.get_state(), key.get_state())
    assert all(v.device.type == "cuda" for v in s2.pos.values())
    assert torch.equal(s2._samples["cfxi"], samples._samples["cfxi"])
