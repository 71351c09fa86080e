"""Port parity: HMC and the NUTS tree (``nifty_tpu_torch/hmc.py``).

Both packages get the same numpy positions and momenta (the port's through
``position_from_numpy``, with a chain axis).  JAX keys and
torch generators give different streams, so the JAX package runs eagerly
(``nifty_tpu.lax.DISABLE_CONTROL_FLOW_PRIM``) while a wrapper around its
``random`` module records every direction and uniform in the order drawn;
the port replays them.  Float64 on the CPU; proposal, endpoints, depth,
turning, diverging, log-weight and cumulative acceptance agree to 1e-10
(the same arithmetic, summed in other orders).  The chains of a batch
reproduce their single runs to 1e-12: masked chains stay frozen.
"""

from functools import partial

import jax
import nifty_tpu.hmc as hj
import nifty_tpu.lax as lax_j
import numpy as np
import pytest
import torch
from jax import numpy as jnp
from jax import random

import nifty_tpu as nj
import nifty_tpu_torch as nt
from nifty_tpu.utils.tree import vdot as jax_vdot
from nifty_tpu_torch import hmc as ht
from nifty_tpu_torch.hmc_oo import Potential, Ravel, kinetic_energy, make_stepper

torch.set_num_threads(1)
TOL = 1e-10


class _Recorder:
    """``jax.random`` for ``nifty_tpu.hmc``, recording the directions and
    uniforms it draws."""

    def __init__(self):
        self.draws = []

    def split(self, key, num=2):
        return random.split(key, num)

    def uniform(self, key, *args, **kwargs):
        u = random.uniform(key, *args, **kwargs)
        self.draws.append(("uniform", float(u)))
        return u

    def bernoulli(self, key, *args, **kwargs):
        b = random.bernoulli(key, *args, **kwargs)
        self.draws.append(("direction", float(b)))
        return b


class _Replay:
    """The port's draw source replaying one recorded sequence a chain."""

    def __init__(self, sequences):
        self.sequences = [list(s) for s in sequences]

    def _next(self, kind, mask):
        out = torch.zeros(len(self.sequences), dtype=torch.float64)
        for c, m in enumerate(mask.tolist()):
            if m:
                got, v = self.sequences[c].pop(0)
                assert got == kind, f"chain {c}: the port asks for a {kind}, the reference drew a {got}"
                out[c] = v
        return out

    def uniform(self, mask):
        return self._next("uniform", mask)

    def direction(self, mask):
        return self._next("direction", mask) > 0.5

    def done(self):
        return all(not s for s in self.sequences)


@pytest.fixture
def record(monkeypatch):
    """Run the JAX package's HMC eagerly and record its draws."""
    monkeypatch.setattr(lax_j, "DISABLE_CONTROL_FLOW_PRIM", True)
    rec = _Recorder()
    monkeypatch.setattr(hj, "random", rec)
    return rec


def _close(got, want, tol=TOL):
    got, want = np.asarray(got, dtype=np.float64), np.asarray(want, dtype=np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * max(np.abs(want).max(), 1.0))


# --- the two targets ------------------------------------------------------------------


def _gaussian(n=8, seed=0):
    """A correlated Gaussian potential in both packages; positions flat."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n, n))
    prec = a @ a.T / n + 0.5 * np.eye(n)
    pj, pt = jnp.asarray(prec), torch.from_numpy(prec)
    pot_j = lambda q: 0.5 * q @ pj @ q  # noqa: E731
    pot_t = lambda q: 0.5 * q @ pt @ q  # noqa: E731
    proto = torch.zeros(n, dtype=torch.float64)
    return pot_j, pot_t, proto


def _field(n=16, seed=3):
    """The standardized posterior of a 16² correlated field under a
    Gaussian likelihood, both packages; positions are dicts."""

    def build(pkg):
        cfm = pkg.CorrelatedFieldMaker("cf")
        cfm.set_amplitude_total_offset(offset_mean=0.0, offset_std=(1e-1, 3e-2))
        cfm.add_fluctuations((n, n), 1.0 / n, (1.0, 5e-1), (-3.0, 2e-1), (1e0, 2e-1))
        return cfm.finalize() if pkg is nj else cfm.finalize(device="cpu", dtype=torch.float64)

    cj, ct = build(nj), build(nt)
    rng = np.random.default_rng(seed)
    data = rng.standard_normal((n, n))
    hj_ = nj.StandardHamiltonian(nj.Gaussian(jnp.asarray(data), noise_cov_inv=4.0).amend(cj))
    ht_ = nt.StandardHamiltonian(nt.Gaussian(torch.from_numpy(data), noise_cov_inv=4.0).amend(ct))
    proto = {k: torch.zeros(ct.domain[k].shape, dtype=torch.float64) for k in sorted(ct.domain)}
    return hj_, ht_, proto


def _setups(target):
    """``(pot_j, stepper_j, ke_j, ravel, potential_t, stepper_t)``."""
    pot_j, pot_t, proto = _gaussian() if target == "gaussian" else _field()
    ravel = Ravel(proto)
    ke_j = lambda inv_m, p: jax_vdot(inv_m, jax.tree_util.tree_map(lambda x: x**2 / 2.0, p))  # noqa: E731
    ke_grad_j = lambda inv_m, p: jax.tree_util.tree_map(jnp.multiply, inv_m, p)  # noqa: E731
    stepper_j = partial(hj.leapfrog_step, jax.grad(pot_j), ke_grad_j)
    potential = Potential(pot_t, ravel)
    return pot_j, stepper_j, ke_j, ravel, potential, make_stepper(potential)


def _state(ravel, seed, momentum_scale=1.0):
    """A position, momentum and inverse mass matrix as numpy trees (flat
    ``(D,)`` arrays unravelled)."""
    rng = np.random.default_rng(seed)
    d = ravel.size
    q, p = 0.3 * rng.standard_normal(d), momentum_scale * rng.standard_normal(d)
    inv_m = rng.uniform(0.5, 1.5, d)
    return q, p, inv_m


def _jtree(ravel, flat):
    tree = ravel.unravel(torch.from_numpy(np.asarray(flat)))
    return jax.tree_util.tree_map(lambda x: jnp.asarray(x.numpy()), tree)


def _jflat(ravel, tree):
    leaves = jax.tree_util.tree_leaves(tree)
    assert len(leaves) == len(ravel.sizes)
    return np.concatenate([np.asarray(x).reshape(-1) for x in leaves])


def _qp_close(got, want_j, ravel):
    _close(got.position[0].numpy(), _jflat(ravel, want_j.position))
    _close(got.momentum[0].numpy(), _jflat(ravel, want_j.momentum))


def _tree_close(got, want, ravel):
    for f in ("left", "right", "proposal_candidate"):
        _qp_close(getattr(got, f), getattr(want, f), ravel)
    for f in ("depth", "turning", "diverging"):
        assert int(getattr(got, f)[0]) == int(getattr(want, f)), f
    _close(float(got.logweight[0]), float(want.logweight))
    _close(float(got.cumulative_acceptance[0]), float(want.cumulative_acceptance))


def _batch(ravel, *flats):
    """Chains of flat numpy states → the port's raveled ``(B, D)`` tensor,
    each chain's tree through ``position_from_numpy`` with a chain axis."""
    domain = torch.utils._pytree.tree_unflatten(
        [nt.ShapeWithDtype(s, torch.float64) for s in ravel.shapes], ravel.spec)
    trees = torch.utils._pytree.tree_map(lambda x: x.numpy(),
                                          ravel.unravel(torch.from_numpy(np.stack(flats))))
    return ravel.ravel(nt.position_from_numpy(domain, trees, device="cpu", batch=(len(flats),)))


# --- leapfrog, plain HMC, the U-turn ------------------------------------------------------


@pytest.mark.parametrize("target", ["gaussian", "field"])
def test_leapfrog_step_matches_jax(target):
    """Five leapfrog steps from the same q and p, forward and backward."""
    pot_j, stepper_j, _, ravel, _, stepper_t = _setups(target)
    q, p, inv_m = _state(ravel, 1)
    for eps in (0.1, -0.07):
        qp_j = hj.QP(_jtree(ravel, q), _jtree(ravel, p))
        qp_t = ht.QP(_batch(ravel, q), _batch(ravel, p))
        for _ in range(5):
            qp_j = stepper_j(eps, _jtree(ravel, inv_m), qp_j)
            qp_t = stepper_t(torch.tensor([eps], dtype=torch.float64), _batch(ravel, inv_m), qp_t)
        _qp_close(qp_t, qp_j, ravel)


@pytest.mark.parametrize("target", ["gaussian", "field"])
@pytest.mark.parametrize("seed", [0, 1])
def test_generate_hmc_acc_rej_matches_jax(record, target, seed):
    """A 6-step trajectory with Metropolis accept/reject, the reference's
    uniform replayed; accepted and rejected states and the flags agree."""
    pot_j, stepper_j, ke_j, ravel, potential, stepper_t = _setups(target)
    q, p, inv_m = _state(ravel, 10 + seed, momentum_scale=2.0)
    want = hj.generate_hmc_acc_rej(
        key=random.PRNGKey(seed), initial_qp=hj.QP(_jtree(ravel, q), _jtree(ravel, p)),
        step_size=0.2, num_steps=6, stepper=stepper_j, potential_energy=pot_j,
        kinetic_energy=ke_j, inverse_mass_matrix=_jtree(ravel, inv_m), max_energy_difference=50.0)
    draws = _Replay([record.draws])
    got = ht.generate_hmc_acc_rej(
        draws=draws, initial_qp=ht.QP(_batch(ravel, q), _batch(ravel, p)), step_size=0.2, num_steps=6,
        stepper=stepper_t, potential_energy=potential.energy, kinetic_energy=kinetic_energy,
        inverse_mass_matrix=_batch(ravel, inv_m), max_energy_difference=50.0)
    assert draws.done()
    _qp_close(got.accepted_qp, want.accepted_qp, ravel)
    _qp_close(got.rejected_qp, want.rejected_qp, ravel)
    assert (bool(got.accepted[0]), bool(got.diverging[0])) == (bool(want.accepted), bool(want.diverging))


def test_is_euclidean_uturn_matches_jax():
    """The criterion on random endpoints (both outcomes occur), and the two
    cases of ``tests/test_hmc.py``."""
    rng = np.random.default_rng(5)
    left = [rng.standard_normal((40, 3)) for _ in range(2)]
    right = [rng.standard_normal((40, 3)) for _ in range(2)]
    got = ht.is_euclidean_uturn(ht.QP(*map(torch.from_numpy, left)),
                                ht.QP(*map(torch.from_numpy, right))).numpy()
    want = [bool(hj.is_euclidean_uturn(hj.QP(*(jnp.asarray(x[i]) for x in left)),
                                       hj.QP(*(jnp.asarray(x[i]) for x in right))))
            for i in range(40)]
    np.testing.assert_array_equal(got, want)
    assert 0 < got.sum() < 40
    qp = lambda q, p: ht.QP(torch.tensor([[q]]), torch.tensor([[p]]))  # noqa: E731
    assert not bool(ht.is_euclidean_uturn(qp(0.0, -1.0), qp(1.0, 1.0))[0])
    assert bool(ht.is_euclidean_uturn(qp(0.0, 1.0), qp(1.0, -1.0))[0])


# --- the NUTS tree -------------------------------------------------------------------------


def _nuts_jax(record, stepper_j, pot_j, ke_j, ravel, q, p, inv_m, key, eps, depth, max_de):
    record.draws.clear()
    tree = hj.generate_nuts_tree(
        hj.QP(_jtree(ravel, q), _jtree(ravel, p)), random.PRNGKey(key), eps, depth, stepper_j,
        pot_j, ke_j, _jtree(ravel, inv_m), max_energy_difference=max_de)
    return tree, list(record.draws)


def _nuts_torch(draws, ravel, stepper_t, potential, qs, ps, inv_ms, eps, depth, max_de):
    return ht.generate_nuts_tree(
        ht.QP(_batch(ravel, *qs), _batch(ravel, *ps)), draws, eps, depth, stepper_t,
        potential.energy, kinetic_energy, _batch(ravel, *inv_ms), max_energy_difference=max_de)


CASES = [  # (target, step size, maximal energy difference, seeds)
    ("gaussian", 0.35, 1000.0, range(6)),
    ("gaussian", 2.6, 8.0, range(3)),  # divergent
    ("field", 0.12, 1000.0, range(3)),
]


@pytest.mark.parametrize("target,eps,max_de,keys", CASES)
def test_generate_nuts_tree_matches_jax(record, target, eps, max_de, keys):
    """Whole trees (depth ≤ 4) from the same q, p and draws; across the
    keys the trajectory grows in both directions, and the large step
    diverges."""
    pot_j, stepper_j, ke_j, ravel, potential, stepper_t = _setups(target)
    directions, diverged = set(), False
    for key in keys:
        q, p, inv_m = _state(ravel, 20 + key)
        want, seq = _nuts_jax(record, stepper_j, pot_j, ke_j, ravel, q, p, inv_m, key, eps, 4, max_de)
        draws = _Replay([seq])
        got = _nuts_torch(draws, ravel, stepper_t, potential, [q], [p], [inv_m], eps, 4, max_de)
        assert draws.done()
        _tree_close(got, want, ravel)
        directions |= {v for kind, v in seq if kind == "direction"}
        diverged |= bool(want.diverging)
    assert directions == {0.0, 1.0}
    assert diverged == (max_de < 100.0)


@pytest.mark.parametrize("target", ["gaussian", "field"])
def test_iterative_build_tree_matches_jax(record, target):
    """One doubling of 2**3 leaves to the right and to the left of a depth-3
    tree, leaf uniforms replayed: the subtree's endpoints, proposal,
    weights and flags."""
    pot_j, stepper_j, ke_j, ravel, potential, stepper_t = _setups(target)
    q, p, inv_m = _state(ravel, 30)
    ke = partial(ke_j, _jtree(ravel, inv_m))
    qp_j = hj.QP(_jtree(ravel, q), _jtree(ravel, p))
    neg_e = -hj.total_energy_of_qp(qp_j, pot_j, ke)
    for go_right in (True, False):
        record.draws.clear()
        base_j = hj.Tree(qp_j, qp_j, neg_e, qp_j, jnp.asarray(False), jnp.asarray(False),
                         jnp.asarray(3), jnp.asarray(0.0))
        want = hj.iterative_build_tree(random.PRNGKey(7), base_j, 0.05, jnp.asarray(go_right),
                                       stepper_j, pot_j, ke_j, _jtree(ravel, inv_m), 4, neg_e, 1000.0)
        draws = _Replay([record.draws])
        qp_t = ht.QP(_batch(ravel, q), _batch(ravel, p))
        neg_t = torch.tensor([float(neg_e)], dtype=torch.float64)
        no = torch.tensor([False])
        base_t = ht.Tree(qp_t, qp_t, neg_t, qp_t, no, no, torch.tensor([3]),
                         torch.zeros(1, dtype=torch.float64))
        got = ht.iterative_build_tree(draws, base_t, 0.05, torch.tensor([go_right]), stepper_t,
                                      potential.energy, kinetic_energy, _batch(ravel, inv_m), 4, neg_t, 1000.0)
        assert draws.done() and len(record.draws) == 7
        _tree_close(got, want, ravel)


def test_a_batch_of_chains_reproduces_each_chain(record):
    """Four chains as one batch, each with its own q, p, mass matrix and
    replayed draws, equal their single-chain runs (and the reference's):
    a chain that stopped keeps its state while the others go on."""
    pot_j, stepper_j, ke_j, ravel, potential, stepper_t = _setups("gaussian")
    states, seqs, wants = [], [], []
    for c in range(4):
        q, p, inv_m = _state(ravel, 40 + c, momentum_scale=0.5 + c)
        want, seq = _nuts_jax(record, stepper_j, pot_j, ke_j, ravel, q, p, inv_m, c, 0.4, 5, 1000.0)
        states.append((q, p, inv_m))
        seqs.append(seq)
        wants.append(want)
    assert len({int(w.depth) for w in wants}) > 1  # the chains stop at different depths
    draws = _Replay(seqs)
    got = _nuts_torch(draws, ravel, stepper_t, potential, *zip(*states), 0.4, 5, 1000.0)
    assert draws.done()
    for c, want in enumerate(wants):
        one = _nuts_torch(_Replay([seqs[c]]), ravel, stepper_t, potential, *zip(states[c]), 0.4,
                          5, 1000.0)
        chain_c = type(got)(*jax.tree_util.tree_map(lambda x: x[c:c + 1], tuple(got)))
        for a, b in zip(torch.utils._pytree.tree_leaves(chain_c), torch.utils._pytree.tree_leaves(one)):
            np.testing.assert_allclose(a.double().numpy(), b.double().numpy(), rtol=1e-12, atol=1e-12)
        _tree_close(chain_c, want, ravel)


def test_chain_draws_do_not_depend_on_the_other_chains():
    """:class:`ChainDraws`: chain ``c``'s uniforms and momenta are those of a
    batch of its key alone, whatever the mask of the others."""
    many, one = ht.ChainDraws([5, 6, 7], "cpu"), ht.ChainDraws([6], "cpu")
    u = many.uniform(torch.tensor([False, True, True]))
    assert float(u[0]) == 0.0 and float(u[1]) == float(one.uniform(torch.tensor([True]))[0])
    sqrt_m = torch.ones(3, 4, dtype=torch.float64)
    np.testing.assert_array_equal(many.momentum(sqrt_m)[1].numpy(),
                                  one.momentum(sqrt_m[1:2])[0].numpy())


def test_a_nan_energy_diverges():
    """A state whose energy is NaN (here beyond |q| = 2) diverges and
    accepts with probability 0, so the tree stops, keeps its proposal and
    the acceptance that drives the step size stays finite.  (The JAX package
    compares NaN as not diverging and carries it into the acceptance.)"""
    pot = lambda q: torch.where(q.abs().max() < 2.0, 0.5 * torch.sum(q**2), torch.nan)  # noqa: E731
    ravel = Ravel(torch.zeros(3, dtype=torch.float64))
    potential = Potential(pot, ravel)
    q = torch.tensor([[1.9, 0.0, 0.0], [0.1, 0.0, 0.0]], dtype=torch.float64)
    p = torch.tensor([[5.0, 0.0, 0.0], [0.5, 0.0, 0.0]], dtype=torch.float64)
    tree = ht.generate_nuts_tree(ht.QP(q, p), ht.ChainDraws([1, 2], "cpu"), 0.5, 4,
                                 make_stepper(potential), potential.energy, kinetic_energy,
                                 torch.ones_like(q))
    assert bool(tree.diverging[0]) and float(tree.cumulative_acceptance[0]) == 0.0
    assert torch.equal(tree.proposal_candidate.position[0], q[0])
    assert bool(torch.isfinite(tree.cumulative_acceptance).all())
    acc = ht.generate_hmc_acc_rej(
        draws=ht.ChainDraws([3, 4], "cpu"), initial_qp=ht.QP(q, p), step_size=0.5, num_steps=3,
        stepper=make_stepper(potential), potential_energy=potential.energy,
        kinetic_energy=kinetic_energy, inverse_mass_matrix=torch.ones_like(q))
    assert bool(acc.diverging[0]) and not bool(acc.accepted[0])
    assert torch.equal(acc.accepted_qp.position[0], q[0])
