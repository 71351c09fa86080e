"""The port's spans and counters (``nifty_tpu_torch/tracing.py``) on the
CPU, on the benchmark's model at 64² with 8 knots: the spans nest by time
under ``torch.profiler``, open nothing and change nothing without it, run
under ``torch.func``'s transforms, and the counters count the solver's
host reads and the relu-feature map's passes."""

import collections

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import nifty_tpu_torch as nt
from nifty_tpu_torch import tracing
from nifty_tpu_torch.bench import workload

torch.set_num_threads(1)
N, KNOTS = 64, 8


def _fixed(n):
    return dict(maxiter=n, miniter=n, resnorm=-1.0)


@pytest.fixture(scope="module")
def model():
    lh, pos, tan = workload.build_likelihood(N, "cpu", torch.float64, n_mode_knots=KNOTS)
    p = nt.position_from_numpy(lh.forward_model, pos)
    t = nt.position_from_numpy(lh.forward_model, tan)
    ham = nt.StandardHamiltonian(lh)
    return lh, ham, p, t


def _solve(ham, p, t, iterations):
    return nt.static_cg(lambda x: ham.metric(p, x), t, **_fixed(iterations)).x


def _spans(prof):
    out = {}
    for ev in prof.events():
        if ev.name.startswith(tracing.PREFIX):
            # a host range, never a user annotation: none is drawn on the device's timeline
            assert not ev.is_user_annotation, ev.name
            out.setdefault(ev.name, []).append((ev.time_range.start, ev.time_range.end))
    return out


@pytest.fixture(scope="module")
def traced(model):
    _, ham, p, t = model
    plain = _solve(ham, p, t, 9)
    before = collections.Counter(tracing.profiled)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        x = _solve(ham, p, t, 9)
    return plain, x, _spans(prof), collections.Counter(tracing.profiled) - before


@pytest.mark.parametrize("outer, inner", [
    ("nt.cg", "nt.cg.matvec"),
    ("nt.cg.matvec", "nt.likelihood.metric"),
    ("nt.likelihood.metric", "nt.cf.forward"),
    ("nt.cf.forward", "nt.pwl.features"),
    ("nt.cf.forward", "nt.hartley"),
    ("nt.likelihood.metric", "nt.pwl.transpose"),
    ("nt.cg", "nt.host_read"),
])
def test_spans_nest_by_time(traced, outer, inner):
    spans = traced[2]
    assert spans[inner] and spans[outer]
    for a, b in spans[inner]:
        assert any(lo <= a and b <= hi for lo, hi in spans[outer]), (inner, a, b)


def test_spans_open_nothing_and_change_nothing_without_a_profiler(model, traced, monkeypatch):
    plain, x, _, _ = traced
    assert all(torch.equal(plain[k], x[k]) for k in plain)  # bitwise: the spans read nothing
    assert not torch.autograd.profiler._is_profiler_enabled
    off = tracing.span("cg")
    assert off is tracing.span("cg") and not isinstance(off, torch.profiler.record_function)

    def refuse(name):
        raise AssertionError(f"{name} opened without a profiler")

    monkeypatch.setattr(tracing, "_On", refuse)
    _, ham, p, t = model
    before = collections.Counter(tracing.profiled)
    _solve(ham, p, t, 2)
    assert tracing.profiled == before  # counted, but not as profiled


def test_profiled_counts_are_those_made_under_the_profiler(traced):
    # 9 iterations, 4 passes each; the flag read after iteration 8
    assert traced[3] == {"pwl_passes": 36, "host_reads": 1}


def _jvp(model):
    lh, _, p, t = model
    return torch.func.jvp(lh.forward_model, (p,), (t,))[1]


def _vjp(model):
    lh, _, p, _ = model
    y, pull = torch.func.vjp(lh.forward_model, p)
    return pull(torch.ones_like(y))[0]


def _vmap(model):
    _, ham, p, t = model
    batch = {k: torch.stack([v, 2 * v]) for k, v in t.items()}
    return torch.func.vmap(lambda x: ham.metric(p, x))(batch)


@pytest.mark.parametrize("transform", [_jvp, _vjp, _vmap], ids=["jvp", "vjp", "vmap"])
def test_spans_run_under_torch_func(model, transform):
    plain = transform(model)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = transform(model)
    spans = _spans(prof)
    assert spans["nt.cf.forward"] and spans["nt.pwl.features"] and spans["nt.hartley"]
    flat = lambda tree: tree.values() if isinstance(tree, dict) else [tree]  # noqa: E731
    assert all(torch.equal(a, b) for a, b in zip(flat(plain), flat(out)))


def _counted(fn):
    """The counters' change over a call of ``fn``."""
    before = collections.Counter(tracing.counts)
    fn()
    return collections.Counter(tracing.counts) - before


def _apply(model):
    _, ham, p, t = model
    return 1, _counted(lambda: ham.metric(p, t))


def _static_cg(model):
    _, ham, p, t = model
    return 21, _counted(lambda: _solve(ham, p, t, 20))  # 20 iterations and the residual's refresh


def _mgvi_short(model):
    """The second of two MGVI iterations as the benchmark's ``mgvi_short``
    mix runs them: 1 pair resampled, draws by static CG 3, one static
    Newton step of CG 2, the KL a loop over the samples."""
    lh, _, _, _ = model
    start = nt.position_from_numpy(lh.forward_model, workload.latent_draw(lh.forward_model.domain, 2))
    opt = nt.OptimizeVI(lh, 2, kl_map="smap", residual_map="vmap")
    state = opt.init_state(
        torch.Generator().manual_seed(2**31 + 11), n_samples=1, sample_mode="linear_resample",
        draw_linear_kwargs=dict(cg=nt.static_cg, cg_kwargs=_fixed(3)),
        kl_kwargs=dict(minimize=nt.static_newton_cg,
                       minimize_kwargs=dict(maxiter=1, cg=nt.static_cg, cg_kwargs=_fixed(2))))
    samples, state = opt.update(nt.Samples(pos=start), state)
    return None, _counted(lambda: opt.update(samples, state))


@pytest.mark.parametrize("run, host_reads", [
    (_apply, 0),
    (_static_cg, 2),  # the stop flag after iterations 8 and 16
    (_mgvi_short, 4),  # the seeds' list and three Newton flags
], ids=["apply", "static_cg", "mgvi_short"])
def test_counters(model, run, host_reads):
    applies, counts = run(model)
    assert counts["host_reads"] == host_reads
    if applies is not None:
        assert counts["pwl_passes"] == 4 * applies  # jvp primal and tangent, vjp, pull-back
