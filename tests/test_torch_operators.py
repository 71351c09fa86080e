"""The port's ``operators`` and ``extra`` against nifty_tpu on the CPU.

Every name of ``operators.__all__``: the linear ones over float64,
float32 and complex128 inputs (the values against the JAX package's
within 1e-12, 1e-5 for float32; the port's ``extra.check_linear_model``
at 1e-12, 1e-4 for float32; the adjoint against ``jax.linear_transpose``),
the others against the JAX package's on dict trees.  ``extra``'s checks
pass on linear maps, models and likelihoods and fail on a map that is not
linear.
"""

import jax
import numpy as np
import pytest
import torch
from jax import numpy as jnp

import nifty_tpu.operators as jops
import nifty_tpu_torch as nt
import nifty_tpu_torch.operators as tops
from nifty_tpu_torch import extra
from nifty_tpu_torch.utils.tree import ShapeWithDtype

torch.set_num_threads(1)
KEEP = np.arange(64).reshape(8, 8) % 3 == 0
TORCH = {np.float64: torch.float64, np.float32: torch.float32, np.complex128: torch.complex128}

# name: (factory of the operator from either module, input shape)
LINEAR = {
    "scaling": (lambda o: o.scaling(2.5), (8, 8)),
    "diagonal": (lambda o: o.diagonal(np.linspace(0.5, 2.0, 64).reshape(8, 8)), (8, 8)),
    "mask": (lambda o: o.mask(KEEP), (8, 8)),
    "mask_adjoint": (lambda o: o.mask_adjoint(KEEP), (22,)),
    "zero_pad": (lambda o: o.zero_pad((12, 14)), (8, 8)),
    "zero_pad_center": (lambda o: o.zero_pad((12, 14), center=True), (8, 7)),
    "central_slice": (lambda o: o.central_slice((4, 6), center=True), (8, 8)),
    "central_slice_corner": (lambda o: o.central_slice((4, 6)), (8, 8)),
    "extract": (lambda o: o.extract_at_indices([0, 3, 5], axis=1), (4, 8)),
    "contraction": (lambda o: o.contraction(1), (4, 8)),
    "contraction_all": (lambda o: o.contraction(), (4, 8)),
    "contraction_w": (lambda o: o.contraction(0, weights=0.25, mean=True), (4, 8)),
    "outer": (lambda o: o.outer_product(np.arange(3.0)), (5,)),
    "matmul": (lambda o: o.matrix_product(np.eye(8) * 2 + 1, axis=0), (8, 4)),
    "transpose": (lambda o: o.transpose_field((1, 0)), (4, 8)),
    "regrid_up": (lambda o: o.regrid((16, 12)), (8, 8)),
    "regrid_down": (lambda o: o.regrid((5, 6)), (8, 8)),
    "interp": (lambda o: o.linear_interpolation(
        np.stack([np.linspace(0.3, 6.5, 11), np.linspace(-1.1, 9.8, 11)]), distances=1.0), (8, 8)),
    "interp_offset": (lambda o: o.linear_interpolation(
        np.stack([np.linspace(0.3, 6.5, 7), np.linspace(0.1, 6.8, 7)]), distances=(0.5, 2.0),
        offset=(0.1, -0.2)), (8, 8)),
    "conv": (lambda o: o.func_convolution((16,), 0.5, lambda r: np.exp(-0.5 * (r / 1.3) ** 2)), (16,)),
    "conv_2d": (lambda o: o.func_convolution((6, 8), (0.5, 0.25), lambda r: 1.0 / (1.0 + r**2)),
                (6, 8)),
    "squeeze": (lambda o: o.squeeze(1), (4, 1, 3)),
    "squeeze_all": (lambda o: o.squeeze(), (4, 1, 3)),
    "value_insert": (lambda o: o.value_inserter((4, 4), (1, 2)), ()),
    "einsum": (lambda o: o.linear_einsum("ij,j->i", m=np.ones((3, 5)) + np.eye(3, 5)), (5,)),
}


def _draw(shape, dtype, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape)
    if dtype == np.complex128:
        x = x + 1j * rng.standard_normal(shape)
    return np.asarray(x, dtype)


@pytest.mark.parametrize("dtype", [np.float64, np.float32, np.complex128])
@pytest.mark.parametrize("name", sorted(LINEAR))
def test_linear_operator_matches_the_reference(name, dtype):
    make, shape = LINEAR[name]
    fj, ft = make(jops), make(tops)
    x = _draw(shape, dtype, 0)
    ref = np.asarray(fj(jnp.asarray(x)))
    got = ft(torch.from_numpy(x))
    tol = 1e-5 if dtype == np.float32 else 1e-12
    np.testing.assert_allclose(got.numpy(), ref, rtol=tol, atol=tol * max(np.abs(ref).max(), 1.0))
    extra.check_linear_model(ft, ShapeWithDtype(shape, TORCH[dtype]), 42, device="cpu",
                             rtol=1e-4 if dtype == np.float32 else 1e-12,
                             atol=1e-4 if dtype == np.float32 else 1e-12)
    # the adjoint: conj(vjp(conj y)), as jax.linear_transpose
    y = _draw(tuple(got.shape), np.float64 if dtype == np.float32 else dtype, 1)
    adj_t = tops.adjoint(ft, torch.from_numpy(x))(torch.from_numpy(y.astype(got.numpy().dtype)))
    adj_j = jax.linear_transpose(fj, jnp.asarray(x))(jnp.asarray(y.astype(ref.dtype)))[0]
    np.testing.assert_allclose(adj_t.numpy(), np.asarray(adj_j), rtol=tol,
                               atol=tol * max(np.abs(adj_j).max(), 1.0))


def test_adjoint_of_a_complex_map_is_the_transpose():
    """For a complex matrix the transpose is not torch's vjp (its conjugate):
    the adjoint helper takes JAX's ``linear_transpose`` convention; from a
    ``ShapeWithDtype`` example too."""
    rng = np.random.default_rng(3)
    m = rng.standard_normal((5, 4)) + 1j * rng.standard_normal((5, 4))
    y = rng.standard_normal(5) + 1j * rng.standard_normal(5)
    ref = jax.linear_transpose(jops.matrix_product(m), jnp.zeros(4, jnp.complex128))(jnp.asarray(y))[0]
    adj = tops.adjoint(tops.matrix_product(m), ShapeWithDtype((4,), torch.complex128), device="cpu")
    np.testing.assert_allclose(adj(torch.from_numpy(y)).numpy(), np.asarray(ref), rtol=1e-13)
    np.testing.assert_allclose(np.asarray(ref), m.T @ y, rtol=1e-13)


def test_mask_roundtrip_and_adder():
    m, ma = tops.mask(KEEP), tops.mask_adjoint(KEEP)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((8, 8)))
    y = ma(m(x)).numpy()
    np.testing.assert_array_equal(y[KEEP], x.numpy()[KEEP])
    assert np.all(y[~KEEP] == 0)
    off = np.arange(3.0)
    np.testing.assert_array_equal(tops.adder(off)(torch.ones(3, dtype=torch.float64)).numpy(),
                                  np.asarray(jops.adder(off)(jnp.ones(3))))
    d = {"a": torch.ones(2, dtype=torch.float64)}
    np.testing.assert_array_equal(tops.adder(d)(d)["a"].numpy(), 2.0)


def test_dict_operators_match_the_reference():
    """``block_diagonal`` (an unknown key raises), ``prepend_key``,
    ``partial_conjugate`` and ``diagonal`` on dict trees and ``Vector``s."""
    x = {"b": np.ones(2) * (1 + 2j), "a": np.arange(3.0) + 0j, "c": np.ones(1) * 3j}
    xt = {k: torch.from_numpy(v) for k, v in x.items()}
    xj = {k: jnp.asarray(v) for k, v in x.items()}
    fns = lambda o: {"a": o.scaling(2.0), "b": o.scaling(-1.0)}  # noqa: E731
    out_t, out_j = tops.block_diagonal(fns(tops))(xt), jops.block_diagonal(fns(jops))(xj)
    for k in x:
        np.testing.assert_array_equal(out_t[k].numpy(), np.asarray(out_j[k]))
    assert isinstance(tops.block_diagonal(fns(tops))(nt.Vector(xt)), nt.Vector)
    with pytest.raises(KeyError):
        tops.block_diagonal({"a": tops.scaling(2.0), "typo": tops.scaling(1.0)})(xt)
    pk = tops.prepend_key("lvl")(nt.Vector(xt))
    assert set(pk) == {"lvl"} and set(pk["lvl"]) == set(x)
    pc_t, pc_j = tops.partial_conjugate(["a", "b"])(xt), jops.partial_conjugate(["a", "b"])(xj)
    for k in x:
        np.testing.assert_array_equal(pc_t[k].resolve_conj().numpy(), np.asarray(pc_j[k]))
    d = {k: np.full(v.shape, 0.5) for k, v in x.items()}
    dg = tops.diagonal({k: torch.from_numpy(v) for k, v in d.items()})(xt)
    for k in x:
        np.testing.assert_array_equal(dg[k].numpy(), 0.5 * x[k])


def test_multifield_vector_roundtrip_in_jax_order():
    """The ravel orders keys as JAX does (sorted, not by insertion),
    promotes the leaves to one dtype and unravels back to each leaf's."""
    from jax.flatten_util import ravel_pytree

    x = {"b": np.ones((2, 2)), "a": np.arange(3.0), "c": {"z": np.full(2, 7.0), "y": np.arange(2.0)}}
    xt = {"b": torch.from_numpy(x["b"]), "a": torch.from_numpy(x["a"]),
          "c": {"z": torch.from_numpy(x["c"]["z"]), "y": torch.from_numpy(x["c"]["y"]).float()}}
    flat = tops.multifield_to_vector(xt)
    ref = np.asarray(ravel_pytree(jax.tree_util.tree_map(jnp.asarray, x))[0])
    assert flat.dtype == torch.float64
    np.testing.assert_array_equal(flat.numpy(), ref)
    np.testing.assert_array_equal(np.asarray(jops.multifield_to_vector(x)), ref)
    back = tops.vector_to_multifield(xt)(flat)
    assert list(back) == list(xt) and back["c"]["y"].dtype == torch.float32
    for k in ("a", "b"):
        np.testing.assert_array_equal(back[k].numpy(), x[k])
    np.testing.assert_array_equal(back["c"]["z"].numpy(), x["c"]["z"])
    assert isinstance(tops.vector_to_multifield(nt.Vector(xt))(flat), nt.Vector)


def test_regrid_preserves_constants_and_convolution_of_a_delta():
    np.testing.assert_allclose(tops.regrid((13, 7))(torch.full((8, 8), 3.25, dtype=torch.float64)).numpy(),
                               3.25, rtol=1e-12)
    f = lambda r: np.exp(-0.5 * r**2)  # noqa: E731
    x = torch.zeros(16, dtype=torch.float64)
    x[3] = 1.0
    r = np.minimum(np.abs(np.arange(16) - 3), 16 - np.abs(np.arange(16) - 3)).astype(float)
    np.testing.assert_allclose(tops.func_convolution((16,), 1.0, f)(x).numpy(), f(r), atol=1e-10)


def test_linear_interpolation_periodic_wrap():
    """``tests/test_operators.py``'s wrap: one period out equals the point."""
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(8))
    out = tops.linear_interpolation(np.array([[0.0, 8.0, 7.5]]), distances=1.0)(x).numpy()
    np.testing.assert_allclose(out[1], out[0], atol=1e-12)
    np.testing.assert_allclose(out[2], 0.5 * float(x[-1] + x[0]), atol=1e-12)


def test_operators_compose_with_models():
    cfm = nt.CorrelatedFieldMaker("cf")
    cfm.set_amplitude_total_offset(0.0, (1e-1, 3e-2))
    cfm.add_fluctuations((16,), 1.0 / 16, (1.0, 0.5), (-3.0, 0.2))
    cf = cfm.finalize(device="cpu", dtype=torch.float64)
    keep = np.arange(16) % 2 == 0
    fwd = nt.ChainModel(tops.mask(keep), cf)
    p = fwd.init(torch.Generator().manual_seed(0), device="cpu", dtype=torch.float64)
    assert tuple(fwd(p).shape) == (8,)
    lh = nt.Gaussian(np.zeros(8), noise_cov_inv=100.0, device="cpu").amend(fwd)
    assert np.isfinite(float(lh.energy(p)))
    extra.check_likelihood_metrics(lh, p, 3)
    extra.check_model_jacobian(nt.ChainModel(torch.exp, cf), p, 4)


def test_extra_checks_fail_where_they_should():
    """A map that is not linear fails the linearity check; an affine one too;
    a model whose jvp disagrees with its values fails the Jacobian check."""
    dom = ShapeWithDtype((6,), torch.float64)
    with pytest.raises(AssertionError):
        extra.check_linear_model(lambda x: x * x, dom, 0, device="cpu")
    with pytest.raises(AssertionError):
        extra.check_linear_model(tops.adder(np.ones(6)), dom, 0, device="cpu")
    extra.check_linear_model(tops.scaling(3.0), dom, 0, device="cpu")

    class WrongJvp(torch.autograd.Function):
        @staticmethod
        def forward(x):
            return x * x

        @staticmethod
        def setup_context(ctx, inputs, output):
            ctx.save_for_forward(inputs[0])

        @staticmethod
        def jvp(ctx, t):
            return 3.0 * t

    with pytest.raises(AssertionError):
        extra.check_model_jacobian(WrongJvp.apply, torch.ones(6, dtype=torch.float64), 1)
    extra.check_model_jacobian(torch.sin, torch.ones(6, dtype=torch.float64), 1)
    with pytest.raises(AssertionError):
        extra.assert_allclose({"a": torch.ones(2)}, {"b": torch.ones(2)})


def test_no_host_transfers_checks_its_level():
    """Without a card the context validates ``level`` and runs its body."""
    with pytest.raises(ValueError):
        with extra.no_host_transfers("sometimes"):
            pass
    for level in ("allow", "log", "disallow", "log_explicit", "disallow_explicit"):
        with extra.no_host_transfers(level):
            pass
    out = extra.check_no_host_transfers(lambda a: a + 1, torch.ones(2))
    np.testing.assert_array_equal(out.numpy(), 2.0)
