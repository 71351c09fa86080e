"""Port parity: the model combinators of ``model.py`` (``LazyModel``,
``VModel``, ``ClipModel``, ``RematModel``) and ``eval_shape``.

``LazyModel`` derives its domain from its initializer and its target from
a call on ``meta`` tensors: a 256² float32 field whose path runs the
kernel Functions (K1's ``ModeExpandGrid`` and the 2-D Hartley) yields its
target without any kernel wrapper being called.  ``VModel`` is held
against the JAX package's ``VModel`` at the same latents for an int, a
key list and a tree ``in_axes``; ``ClipModel`` against its ``ClipModel``;
``RematModel`` against its inner model in value, jvp, vjp, vmap and the
Poisson metric, also under ``vmap``.  Float64 on the CPU, tolerance 1e-10 (the same
arithmetic); ``RematModel`` reruns the same operations, so it matches its
inner model exactly.
"""

import logging

import jax
import numpy as np
import pytest
import torch
from jax import numpy as jnp

import nifty_tpu as nj
import nifty_tpu_torch as nt
from nifty_tpu.model import _parse_axes as jax_parse_axes
from nifty_tpu_torch.model import _parse_axes
from nifty_tpu_torch.ops import cuda_expand, cuda_fft

torch.set_num_threads(1)
TOL = 1e-10


def _close(got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * max(np.abs(want).max(), 1e-300))


def _cf(pkg, shape, dtype=torch.float64, prefix="cf"):
    cfm = pkg.CorrelatedFieldMaker(prefix)
    cfm.set_amplitude_total_offset(0.0, (1e-1, 3e-2))
    cfm.add_fluctuations(shape, 1.0 / shape[0], (1.0, 0.5), (-3.0, 0.2), (1.0, 0.2))
    return cfm.finalize() if pkg is nj else cfm.finalize(device="cpu", dtype=dtype)


def _draw(domain, seed):
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal(v.shape) for k, v in sorted(domain.items())}


class _Lazy(nt.LazyModel):
    def __init__(self, init):
        super().__init__(init=init)

    def forward(self, x):
        return torch.stack([x["a"].sum(), x["b"]])


def test_lazy_model_domain_target_init():
    init = {"a": lambda g, device, dtype: torch.randn((3, 2), generator=g, device=device, dtype=dtype),
            "b": lambda g, device, dtype: torch.randn((), generator=g, device=device, dtype=dtype)}
    m = _Lazy(init)
    assert {k: v.shape for k, v in m.domain.items()} == {"a": (3, 2), "b": ()}
    assert m.target.shape == (2,)
    draw = m.init(torch.Generator().manual_seed(0), device="cpu", dtype=torch.float64)
    assert draw["a"].shape == (3, 2) and draw["a"].dtype == torch.float64
    white = nt.LazyModel(domain={"x": nt.ShapeWithDtype((4,))})
    with pytest.warns(UserWarning, match="no initializer"):
        assert white.init(torch.Generator(), device="cpu")["x"].shape == (4,)


def test_target_on_meta_through_the_kernel_functions(monkeypatch):
    """A 256² float32 exact field: K1's Function and the 2-D Hartley's take
    their shape-only path on meta; no kernel wrapper is called."""
    cf = _cf(nt, (256, 256), torch.float32)
    assert cuda_fft.cuda_hartley_supported((256, 256), torch.float32)

    def refuse(*_, **__):
        raise AssertionError("a kernel wrapper ran while taking shapes")

    for mod, name in ((cuda_expand, "expand_to_grid"), (cuda_expand, "collapse_from_grid"),
                      (cuda_fft, "hartley2d")):
        monkeypatch.setattr(mod, name, refuse)
    import nifty_tpu_torch.ops.mode_expand as me
    monkeypatch.setattr(me, "expand_to_grid", refuse)
    monkeypatch.setattr(me, "collapse_from_grid", refuse)
    target = cf.target
    assert target.shape == (256, 256) and target.dtype == torch.float32
    model = nt.ChainModel(torch.exp, cf)
    assert nt.model.eval_shape(model, model.domain).shape == (256, 256)
    # and the real call still goes through them
    with pytest.raises(AssertionError, match="kernel wrapper"):
        cf(nt.position_from_numpy(cf, _draw(cf.domain, 0)))


def test_reference_parse_axes_reads_a_dict_as_a_key_list():
    """The JAX package's ``_parse_axes`` maps every key of a dict at 0, its
    None leaves lost (ROADMAP C.3); the port keeps them."""
    dom_j = {"a": nj.ShapeWithDtype((2,)), "b": nj.ShapeWithDtype(())}
    dom_t = {"a": nt.ShapeWithDtype((2,)), "b": nt.ShapeWithDtype(())}
    assert jax_parse_axes({"a": 0, "b": None}, dom_j) == {"a": 0, "b": 0}
    assert _parse_axes({"a": 0, "b": None}, dom_t) == {"a": 0, "b": None}
    assert _parse_axes(["a"], dom_t) == {"a": 0, "b": None}
    assert _parse_axes(1, dom_t) == {"a": 1, "b": 1}
    with pytest.raises(ValueError):
        _parse_axes({"a": 0}, dom_t)


def _vmodel_case(in_axes_t, in_axes_j, shape=(24, 24), n=3):
    cj, ct = _cf(nj, shape), _cf(nt, shape)
    vj, vt = nj.VModel(cj, n, in_axes=in_axes_j), nt.VModel(ct, n, in_axes=in_axes_t)
    shapes = {k: tuple(v.shape) for k, v in vj.domain.items()}
    assert {k: v.shape for k, v in vt.domain.items()} == shapes
    rng = np.random.default_rng(1)
    pos = {k: rng.standard_normal(s) for k, s in shapes.items()}
    tan = {k: rng.standard_normal(s) for k, s in shapes.items()}
    jp, jt = ({k: jnp.asarray(v) for k, v in t.items()} for t in (pos, tan))
    tp, tt = (nt.position_from_numpy(vt, t) for t in (pos, tan))
    jy, jdy = jax.jvp(vj, (jp,), (jt,))
    ty, tdy = torch.func.jvp(vt, (tp,), (tt,))
    _close(ty, jy)
    _close(tdy, jdy)
    assert vt.target.shape == (n,) + shape
    draw = vt.init(torch.Generator().manual_seed(2), device="cpu", dtype=torch.float64)
    assert {k: v.shape for k, v in draw.items()} == shapes


@pytest.mark.parametrize("kind", ["int", "keys", "tree"])
def test_vmodel_matches_jax(kind):
    if kind == "int":
        _vmodel_case(0, 0)
    elif kind == "keys":
        _vmodel_case(["cfxi"], ["cfxi"])
    else:
        # the reference's tree form loses its Nones (see above): its key
        # list is the same mapping
        dom = _cf(nt, (24, 24)).domain
        _vmodel_case({k: (0 if k in ("cfxi", "cfzeromode") else None) for k in dom},
                     ["cfxi", "cfzeromode"])


def test_vmodel_metric_equals_separate_applies():
    cf = _cf(nt, (48, 48))
    vm = nt.VModel(cf, 3, in_axes=["cfxi"])
    counts = np.random.default_rng(3).poisson(1.5, (3, 48, 48))
    lh = nt.Poissonian(counts, device="cpu").amend(nt.ChainModel(torch.exp, vm))
    p = nt.position_from_numpy(vm, _draw(vm.domain, 4))
    t = nt.position_from_numpy(vm, _draw(vm.domain, 5))
    m = lh.metric(p, t)
    parts = []
    for i in range(3):
        lh_i = nt.Poissonian(counts[i], device="cpu").amend(nt.ChainModel(torch.exp, cf))
        pi = {k: (v[i] if k == "cfxi" else v) for k, v in p.items()}
        ti = {k: (v[i] if k == "cfxi" else v) for k, v in t.items()}
        parts.append(lh_i.metric(pi, ti))
    _close(m["cfxi"], torch.stack([q["cfxi"] for q in parts]))
    for k in m:
        if k != "cfxi":
            _close(m[k], sum(q[k] for q in parts))


def test_clip_model_matches_jax(caplog):
    jm = nj.Model(lambda x: jnp.sum(x**2), domain=nj.ShapeWithDtype((3,)), white_init=True)
    tm = nt.Model(lambda x: torch.sum(x**2), domain=nt.ShapeWithDtype((3,)))
    x = np.array([5.0, -7.0, 0.5])
    jc = nj.ClipModel(jm, threshold=1.0)
    tc = nt.ClipModel(tm, threshold=1.0)
    _close(float(tc(torch.from_numpy(x))), float(jc(jnp.asarray(x))))
    _close(torch.func.grad(tc)(torch.from_numpy(x)), jax.grad(jc)(jnp.asarray(x)))
    custom = nt.ClipModel(tm, custom_clip_func=torch.tanh)
    _close(float(custom(torch.from_numpy(x))),
           float(nj.ClipModel(jm, custom_clip_func=jnp.tanh)(jnp.asarray(x))))
    warned = nt.ClipModel(tm, threshold=1.0, warn=True)
    with caplog.at_level(logging.WARNING, logger="nifty_tpu_torch"):
        warned(torch.from_numpy(x))
        warned(torch.from_numpy(0.1 * x))
    assert sum("clipping latent inputs" in r.message for r in caplog.records) == 1
    cf = _cf(nt, (24, 24))
    cc = nt.ClipModel(cf, threshold=2.0)
    pos = nt.position_from_numpy(cf, {k: 3 * v for k, v in _draw(cf.domain, 6).items()})
    _close(cc(pos), cf({k: v.clamp(-2.0, 2.0) for k, v in pos.items()}))


@pytest.mark.parametrize("shape", [(48, 48), (64,)])
def test_remat_model(shape):
    cf = _cf(nt, shape)
    rm = nt.RematModel(cf)
    assert rm.domain == cf.domain
    p = nt.position_from_numpy(cf, _draw(cf.domain, 7))
    t = nt.position_from_numpy(cf, _draw(cf.domain, 8))
    np.testing.assert_array_equal(rm(p).numpy(), cf(p).numpy())
    y, jt = torch.func.jvp(rm, (p,), (t,))
    y0, jt0 = torch.func.jvp(cf, (p,), (t,))
    np.testing.assert_array_equal(jt.numpy(), jt0.numpy())
    c = torch.from_numpy(np.random.default_rng(9).standard_normal(shape))
    g = torch.func.vjp(rm, p)[1](c)[0]
    g0 = torch.func.vjp(cf, p)[1](c)[0]
    for k in g:
        _close(g[k], g0[k])
    pb = {k: torch.stack([v, 0.5 * v]) for k, v in p.items()}
    tb = {k: torch.stack([v, -v]) for k, v in t.items()}
    _close(torch.func.vmap(rm)(pb), torch.func.vmap(cf)(pb))
    _, a = torch.func.jvp(torch.func.vmap(rm), (pb,), (tb,))
    _, b = torch.func.jvp(torch.func.vmap(cf), (pb,), (tb,))
    _close(a, b)
    cb = torch.stack([c, 2 * c])
    a = torch.func.vjp(torch.func.vmap(rm), pb)[1](cb)[0]
    b = torch.func.vjp(torch.func.vmap(cf), pb)[1](cb)[0]
    for k in a:
        _close(a[k], b[k])
    counts = np.random.default_rng(10).poisson(1.0, shape)
    lr = nt.Poissonian(counts, device="cpu").amend(nt.ChainModel(torch.exp, rm))
    l0 = nt.Poissonian(counts, device="cpu").amend(nt.ChainModel(torch.exp, cf))
    m, m0 = lr.metric(p, t), l0.metric(p, t)
    for k in m:
        _close(m[k], m0[k])
    # the metric under vmap: a vjp inside a backward under vmap (the KL of MGVI samples)
    mb, mb0 = torch.func.vmap(lr.metric)(pb, tb), torch.func.vmap(l0.metric)(pb, tb)
    for k in mb:
        _close(mb[k], mb0[k])


def test_remat_model_frees_intermediates_between_vjp_and_pullback():
    """Under autograd the remat forward saves only its inputs: fewer bytes
    wait for the pull-back than the inner model's intermediates."""
    cf = _cf(nt, (64, 64))
    p = nt.position_from_numpy(cf, _draw(cf.domain, 11))

    def saved_bytes(model):
        sizes = []

        def pack(t):
            sizes.append(t.numel() * t.element_size())
            return t

        x = {k: v.clone().requires_grad_(True) for k, v in p.items()}
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            y = model(x).sum()
        y.backward()
        assert all(bool(torch.isfinite(v.grad).all()) for v in x.values())
        return sum(sizes)

    assert saved_bytes(nt.RematModel(cf)) < 0.5 * saved_bytes(cf)
