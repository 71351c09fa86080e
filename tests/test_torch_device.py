"""The port's entry points build on the CUDA card unless told ``device="cpu"``.

Without a card (``torch.cuda.is_available`` patched to False, so these
tests mean the same on a machine with one) each entry point that makes
tensors raises instead of building on the CPU; with ``device="cpu"`` it
builds there.
"""

import numpy as np
import pytest
import torch

import nifty_tpu_torch as nt


def _maker(n=16):
    cfm = nt.CorrelatedFieldMaker("cf")
    cfm.set_amplitude_total_offset(offset_mean=1.0, offset_std=(1e-1, 3e-2))
    cfm.add_fluctuations((n, n), 1.0 / n, (1.0, 5e-1), (-3.0, 2e-1), (1e0, 2e-1))
    return cfm


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_finalize_without_card_raises(no_card):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _maker().finalize()


@pytest.mark.parametrize(
    "entry",
    [
        lambda: nt.Initializer({"x": lambda g, device, dtype: torch.zeros(1, device=device)})(
            torch.Generator()
        ),
        lambda: nt.random_like(torch.Generator(), {"x": nt.ShapeWithDtype((3,))}),
        lambda: nt.position_from_numpy(nt.Model(lambda x: x, domain={"x": nt.ShapeWithDtype((2,))}), {"x": np.zeros(2)}),
        lambda: nt.Poissonian(np.ones(4, np.int32)),
        lambda: nt.Gaussian(np.ones(4)),
    ],
    ids=["Initializer", "random_like", "position_from_numpy", "Poissonian", "Gaussian"],
)
def test_entry_points_without_card_raise(no_card, entry):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry()


def test_entry_points_build_on_the_cpu_when_asked(no_card):
    cfm = _maker()
    cf = cfm.finalize(device="cpu")
    assert all(b.device.type == "cpu" for b in cf.buffers())
    assert cf.amplitudes[0].mode_multiplicity.dtype == torch.float32  # the card's working type
    cf64 = cfm.finalize(device="cpu", dtype=torch.float64)
    assert cf.amplitudes[0].mode_multiplicity.dtype == torch.float32  # not moved by the second
    pos = {k: np.zeros(v.shape) for k, v in cf64.domain.items()}
    p = nt.position_from_numpy(cf, pos)  # the model's device and dtype
    assert all(v.device.type == "cpu" and v.dtype == torch.float32 for v in p.values())
    assert all(v.dtype == torch.float64 for v in nt.position_from_numpy(cf64, pos).values())
    r = cf.init(torch.Generator().manual_seed(0), device="cpu", dtype=torch.float32)
    assert torch.isfinite(cf(r)).all()
    data = torch.ones(4, dtype=torch.int32)
    assert nt.Poissonian(data).data is data  # a tensor stays where it is
    assert nt.Gaussian(np.ones(4), noise_std_inv=np.full(4, 2.0), device="cpu").std_weight.device.type == "cpu"
