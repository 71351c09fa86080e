"""The plain reference held to the port at small sizes, both in float64
on the CPU: the field, the metric, the energy and its gradient, the white
noise of a sample's key, and one MGVI iteration's samples and step."""

from __future__ import annotations

import pytest
import torch

import nifty_tpu_torch as nt
from fieldbench.harness.judge import _rel
from fieldbench.reference import philox
from fieldbench.reference.field import Field
from fieldbench.reference.inference import Posterior

MODEL = dict(prefix="cf", grid_side=64, offset_mean=1.0, offset_std=[0.1, 0.03],
             fluctuations=[1.0, 0.5], loglogavgslope=[-3.0, 0.2], flexibility=[1.0, 0.2])


def _port(model):
    n = model["grid_side"]
    cfm = nt.CorrelatedFieldMaker(model["prefix"])
    cfm.set_amplitude_total_offset(offset_mean=1.0, offset_std=(1e-1, 3e-2))
    cfm.add_fluctuations((n, n), distances=1.0 / n, fluctuations=(1.0, 5e-1),
                         loglogavgslope=(-3.0, 2e-1), flexibility=(1e0, 2e-1),
                         n_mode_knots=model["n_mode_knots"])
    return cfm.finalize(device="cpu", dtype=torch.float64)


@pytest.fixture(params=[None, 16], ids=["exact", "knots16"])
def pair(request):
    model = dict(MODEL, n_mode_knots=request.param)
    ref = Field(model, "cpu")
    cf = _port(model)
    gen = torch.Generator().manual_seed(3)
    pos = {k: torch.randn(s, generator=gen, dtype=torch.float64) for k, s in sorted(ref.domain().items())}
    data = torch.poisson(torch.exp(ref.forward(pos)), generator=gen).to(torch.int32)
    lh = nt.Poissonian(data, device="cpu").amend(nt.ChainModel(torch.exp, cf))
    tan = {k: torch.randn(s, generator=gen, dtype=torch.float64) for k, s in sorted(ref.domain().items())}
    return ref, cf, lh, Posterior(ref, data), pos, tan


def test_the_domain_and_the_field(pair):
    ref, cf, _, _, pos, _ = pair
    assert {k: tuple(v.shape) for k, v in cf.domain.items()} == ref.domain()
    assert float((cf(pos) - ref.forward(pos)).abs().max()) <= 1e-12 * float(ref.forward(pos).abs().max())


def test_the_metric_energy_and_gradient(pair):
    _, _, lh, post, pos, tan = pair
    got = lh.metric(pos, tan)
    assert _rel({k: got[k] + tan[k] for k in tan}, post.metric_at(pos)(tan)) <= 1e-12
    e, g = nt.optimize.value_and_grad(nt.StandardHamiltonian(lh))(pos)
    e_ref, g_ref = post.energy_and_grad(pos)
    assert abs(float(e) - float(e_ref)) <= 1e-12 * abs(float(e_ref))
    assert _rel(g, g_ref) <= 1e-12


def test_the_white_noise_is_the_counter_draw(pair):
    _, _, lh, post, pos, _ = pair
    from nifty_tpu_torch.evi import white_noise

    got = white_noise(lh, pos, 2**40 + 12345)
    data, prior = post.white_noise(2**40 + 12345, pos)
    assert torch.equal(got.data, data)
    assert all(torch.equal(got.prior[k], prior[k]) for k in prior)
    assert philox.normal(7, 3, (5,)).shape == (5,)


def test_one_mgvi_iteration(pair):
    """A few CG steps, where float64 solves of one system still agree."""
    _, _, lh, post, pos, _ = pair
    opt = nt.OptimizeVI(lh, 1)
    fixed = dict(maxiter=4, miniter=4, resnorm=-1.0)
    state = opt.init_state(torch.Generator().manual_seed(7), n_samples=2, sample_mode="linear_resample",
                           draw_linear_kwargs=dict(cg=nt.static_cg, cg_kwargs=fixed),
                           kl_kwargs=dict(minimize=nt.static_newton_cg,
                                          minimize_kwargs=dict(maxiter=1, cg_kwargs=fixed)))
    samples, _ = opt.update(nt.Samples(pos=pos), state)
    keys = torch.randint(0, 2**62, (2,), generator=torch.Generator().manual_seed(7)).tolist()
    residuals, new_x, trials = post.mgvi_iteration(pos, keys, 4, 4)
    assert trials == 1
    for got, want in zip(samples, residuals):
        assert _rel({k: v - samples.pos[k] for k, v in got.items()}, want) <= 1e-8
    assert _rel(samples.pos, new_x) <= 1e-8
