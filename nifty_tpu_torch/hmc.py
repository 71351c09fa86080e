"""Hamiltonian Monte Carlo and multinomial NUTS on chains batched along a
leading axis (counterpart of ``nifty_tpu/hmc.py``).

The JAX package builds the NUTS tree iteratively (Phan & Pradhan,
arXiv:1912.11554) inside ``lax.while_loop`` and maps chains with
``jax.vmap``.  ``torch.func.vmap`` cannot pass through host loops, so here
the chains are an explicit leading axis of every position and momentum
(a forest), the per-chain scalars (step size, depth, log-weight, turning,
diverging, cumulative acceptance) are ``(B,)`` tensors, and
:func:`_select` masks every update: a chain that has stopped
keeps its state, as under JAX's batched ``while_loop``.  Within one
doubling the leaf counter ``n`` is shared; chain ``c`` builds leaves while
``n < 2**depth_c`` and it has neither turned nor diverged.  Only the
potential's energy and gradient see all chains at once (``stepper`` and
``potential_energy`` take forests), so each kernel launches once per batch.

Random numbers come from a draw source with ``direction(mask)`` and
``uniform(mask)``, each returning a ``(B,)`` tensor and drawing only for
the chains in ``mask``, in the JAX package's order: in each doubling the
direction, one uniform per leaf after the first, one merge uniform if the
subtree merged.  :class:`ChainDraws` reads one :class:`torch.Generator`
per chain, so a chain's draws do not depend on the chains beside it; a
test can hand in a recorded sequence instead.

Energies are ``(B,)`` tensors (float64 when the likelihoods accumulate in
float64); the transition weights use the multinomial scheme with
progressive biased doubling (Betancourt, arXiv:1701.02434).  A state whose
energy is not a number (an overflow, as a float32 field's ``exp`` gives
under too large a step) diverges and accepts with probability 0; the JAX
package compares NaN as not diverging and lets it reach the step-size
adaptation, whose state it then poisons.  Finite energies behave as there.
"""

from __future__ import annotations

import math
from functools import partial
from typing import Any, Callable, NamedTuple, Union

import torch
from torch.utils._pytree import tree_leaves

from .utils.tree import ShapeWithDtype, random_like, stack, tree_map

__all__ = [
    "QP",
    "Tree",
    "AcceptedAndRejected",
    "ChainDraws",
    "flip_momentum",
    "sample_momentum_from_diagonal",
    "leapfrog_step",
    "total_energy_of_qp",
    "generate_hmc_acc_rej",
    "generate_nuts_tree",
    "iterative_build_tree",
    "merge_trees",
    "is_euclidean_uturn",
]


class QP(NamedTuple):
    """A position/momentum phase-space point (both trees, or forests with a
    leading chain axis)."""

    position: Any
    momentum: Any


class ChainDraws:
    """The random numbers of a batch of chains: chain ``c`` draws from its
    own :class:`torch.Generator` on ``device``, seeded with the integer
    ``keys[c]``.  ``direction``/``uniform`` draw a float64 uniform for each
    chain of ``mask`` (in chain order) and leave the others at 0.
    ``batched`` is False for the draws of a chain given without a chain
    axis."""

    batched = True

    def __init__(self, keys, device, generators=None):
        self.keys = [int(k) for k in keys]
        self.device = torch.device(device)
        self.generators = generators or [
            torch.Generator(device=self.device).manual_seed(k) for k in self.keys
        ]

    def __len__(self):
        return len(self.keys)

    def chain(self, c) -> "ChainDraws":
        """Chain ``c``'s draws as a batch of one (its generator shared)."""
        return ChainDraws([self.keys[c]], self.device, [self.generators[c]])

    def uniform(self, mask) -> torch.Tensor:
        out = torch.zeros(len(self), dtype=torch.float64, device=self.device)
        for c, m in enumerate(mask.tolist()):
            if m:
                out[c] = torch.rand((), generator=self.generators[c], device=self.device,
                                    dtype=torch.float64)
        return out

    def direction(self, mask) -> torch.Tensor:
        """``True`` (right) with probability ½, as ``random.bernoulli``."""
        return self.uniform(mask) < 0.5

    def normal(self, proto):
        """Standard-normal draws shaped like the tree ``proto`` (tensors or
        :class:`ShapeWithDtype` with dtypes), one a chain, stacked."""
        return stack([random_like(g, proto, device=self.device) for g in self.generators])

    def momentum(self, mass_matrix_sqrt):
        """A momentum ``p ~ N(0, M)`` a chain, ``mass_matrix_sqrt`` a forest
        of √M with the chain axis."""
        return stack([
            sample_momentum_from_diagonal(
                generator=g, mass_matrix_sqrt=tree_map(lambda m, c=c: m[c], mass_matrix_sqrt))
            for c, g in enumerate(self.generators)
        ])


def _pick(mask, a, b):
    """``a`` where ``mask`` (``(B,)``), else ``b``, chainwise over
    equal-structure trees of tensors, tuples and dicts."""
    if isinstance(a, torch.Tensor):
        return torch.where(mask.reshape(tuple(mask.shape) + (1,) * (a.ndim - mask.ndim)), a, b)
    if isinstance(a, dict):
        return {k: _pick(mask, a[k], b[k]) for k in a}
    picked = (_pick(mask, x, y) for x, y in zip(a, b))
    return type(a)(*picked) if hasattr(a, "_fields") else type(a)(picked)


def _select(mask, a, b):
    """:func:`_pick`, the mask read on the host first, so a mask that is
    all one way costs no tensor operation."""
    flags = mask.tolist()
    if all(flags):
        return a
    if not any(flags):
        return b
    return _pick(mask, a, b)


def flip_momentum(qp: QP) -> QP:
    return QP(position=qp.position, momentum=tree_map(torch.neg, qp.momentum))


def sample_momentum_from_diagonal(*, generator, mass_matrix_sqrt):
    """Draw p ~ N(0, M) for a diagonal mass matrix given √M (a tree of
    tensors), from ``generator`` on √M's device."""
    device = tree_leaves(mass_matrix_sqrt)[0].device
    noise = random_like(generator, tree_map(ShapeWithDtype.from_leave, mass_matrix_sqrt),
                        device=device)
    return tree_map(torch.mul, mass_matrix_sqrt, noise)


def _per_chain(s, x):
    """A scalar or ``(B,)`` tensor ``s`` shaped to scale the leaf ``x`` (a
    leading chain axis), in ``x``'s dtype."""
    s = torch.as_tensor(s, dtype=x.real.dtype, device=x.device)
    return s.reshape(tuple(s.shape) + (1,) * (x.ndim - s.ndim)) if s.ndim else s


def _axpy(alpha, x, y):
    if isinstance(x, torch.Tensor):
        return y + _per_chain(alpha, x) * x
    return tree_map(lambda xe, ye: ye + _per_chain(alpha, xe) * xe, x, y)


def leapfrog_step(
    potential_energy_gradient: Callable,
    kinetic_energy_gradient: Callable,
    step_size: Union[float, torch.Tensor],
    inverse_mass_matrix,
    qp: QP,
) -> QP:
    """One (velocity-Verlet) leapfrog step; ``step_size`` (a number or
    ``(B,)``) carries the integration direction in its sign.  The gradient
    is evaluated at both ends, as in the JAX package."""
    q, p = qp.position, qp.momentum
    dU = potential_energy_gradient(q)
    p_half = _axpy(-0.5 * step_size, dU, p)
    dT = kinetic_energy_gradient(inverse_mass_matrix, p_half)
    q_new = _axpy(step_size, dT, q)
    dU_new = potential_energy_gradient(q_new)
    p_new = _axpy(-0.5 * step_size, dU_new, p_half)
    return QP(position=q_new, momentum=p_new)


def total_energy_of_qp(qp, potential_energy, kinetic_energy_w_inv_mass):
    return potential_energy(qp.position) + kinetic_energy_w_inv_mass(qp.momentum)


def _chain_scalar(s, batch, device):
    """A step size as a float64 ``(B,)`` tensor."""
    return torch.as_tensor(s, dtype=torch.float64, device=device).expand(batch)


# --- plain HMC ---------------------------------------------------------------


class AcceptedAndRejected(NamedTuple):
    accepted_qp: QP
    rejected_qp: QP
    accepted: torch.Tensor
    diverging: torch.Tensor


def generate_hmc_acc_rej(
    *,
    draws,
    initial_qp: QP,
    step_size,
    num_steps,
    stepper,
    potential_energy,
    kinetic_energy,
    inverse_mass_matrix,
    max_energy_difference=math.inf,
) -> AcceptedAndRejected:
    """A fixed-length leapfrog trajectory of each chain with Metropolis
    accept/reject, one uniform a chain from ``draws``."""
    ke = partial(kinetic_energy, inverse_mass_matrix)
    energy_start = total_energy_of_qp(initial_qp, potential_energy, ke)
    new_qp = initial_qp
    for _ in range(int(num_steps)):
        new_qp = stepper(step_size, inverse_mass_matrix, new_qp)
    # flip momentum to make the proposal an involution
    new_qp = flip_momentum(new_qp)
    energy_end = total_energy_of_qp(new_qp, potential_energy, ke)
    energy_diff = energy_start - energy_end
    diverging = _diverging(energy_diff, max_energy_difference)
    acc_prob = _acceptance(energy_diff)
    accept = draws.uniform(torch.ones_like(diverging)) < acc_prob
    return AcceptedAndRejected(
        accepted_qp=_select(accept, new_qp, initial_qp),
        rejected_qp=_select(accept, initial_qp, new_qp),
        accepted=accept,
        diverging=diverging,
    )


# --- NUTS --------------------------------------------------------------------


class Tree(NamedTuple):
    """A NUTS trajectory fragment of each chain.

    ``logweight`` is the logsumexp of the negative total energies of the
    tree's leaves (the multinomial weight); ``proposal_candidate`` is the
    progressively sampled leaf; ``cumulative_acceptance`` sums the
    per-leaf Metropolis acceptance probabilities (for step-size
    adaptation).  Scalars are ``(B,)``.
    """

    left: QP
    right: QP
    logweight: torch.Tensor
    proposal_candidate: QP
    turning: torch.Tensor
    diverging: torch.Tensor
    depth: torch.Tensor
    cumulative_acceptance: torch.Tensor


def _chain_vdot(a, b):
    """Per-chain real inner product of two forests, ``(B,)``."""
    terms = [(x.conj() * y).real.reshape(x.shape[0], -1).sum(-1)
             for x, y in zip(tree_leaves(a), tree_leaves(b))]
    return sum(terms[1:], terms[0])


def is_euclidean_uturn(qp_left: QP, qp_right: QP):
    """Betancourt's Euclidean no-U-turn criterion across two endpoints, a
    chain each."""
    dq = tree_map(torch.sub, qp_right.position, qp_left.position)
    neg_dq = tree_map(torch.neg, dq)
    return (_chain_vdot(qp_right.momentum, dq) < 0.0) & (_chain_vdot(qp_left.momentum, neg_dq) < 0.0)


def _diverging(delta, max_energy_difference):
    """``|delta| > max_energy_difference``, and NaN diverges."""
    return ~(torch.abs(delta) <= max_energy_difference)


def _acceptance(delta):
    """``min(1, exp(delta))``, 0 for NaN."""
    return torch.nan_to_num(torch.clamp(torch.exp(delta), max=1.0), nan=0.0)


def _leaf_tree(z, neg_energy, initial_neg_energy, max_energy_difference) -> Tree:
    diverging = _diverging(neg_energy - initial_neg_energy, max_energy_difference)
    acc = _acceptance(neg_energy - initial_neg_energy)
    return Tree(
        left=z,
        right=z,
        logweight=neg_energy,
        proposal_candidate=z,
        turning=torch.zeros_like(diverging),
        diverging=diverging,
        depth=torch.zeros(diverging.shape, dtype=torch.int64, device=diverging.device),
        cumulative_acceptance=acc,
    )


def _add_leaf_to_tree(u, tree: Tree, z: QP, go_right, neg_energy_of, initial_neg_energy,
                      max_energy_difference) -> Tree:
    """Multinomial-progressively absorb the single new leaf ``z``; ``u`` the
    uniforms of the choice."""
    neg_e = neg_energy_of(z)
    diverging = _diverging(neg_e - initial_neg_energy, max_energy_difference)
    logw_tot = torch.logaddexp(tree.logweight, neg_e)
    take_new = u < torch.exp(neg_e - logw_tot)
    acc = tree.cumulative_acceptance + _acceptance(neg_e - initial_neg_energy)
    return Tree(
        left=_select(go_right, tree.left, z),
        right=_select(go_right, z, tree.right),
        logweight=logw_tot,
        proposal_candidate=_select(take_new, z, tree.proposal_candidate),
        turning=tree.turning,
        diverging=tree.diverging | diverging,
        depth=tree.depth,
        cumulative_acceptance=acc,
    )


def _trailing_ones(n: int) -> int:
    c = 0
    while n & 1:
        n, c = n >> 1, c + 1
    return c


def iterative_build_tree(
    draws,
    initial_tree: Tree,
    step_size,
    go_right,
    stepper,
    potential_energy,
    kinetic_energy,
    inverse_mass_matrix,
    max_tree_depth: int,
    initial_neg_energy,
    max_energy_difference,
    active=None,
) -> Tree:
    """Build, for each chain of ``active`` (all by default), a new subtree
    of ``2**initial_tree.depth`` leapfrog states adjacent to its tree in
    direction ``go_right``.

    U-turn checks inside the subtree use the checkpoint scheme of
    arXiv:1912.11554 (alg. 2): even-numbered leaves are pushed onto a
    ``max_tree_depth``-slot stack at slot ``popcount(n)``; odd leaves check
    against the stacked endpoints of every complete subtree they close.  A
    chain that stopped early gets depth -1.  Chains outside ``active``
    compute alongside but draw nothing; their result is meaningless.
    """
    ke = partial(kinetic_energy, inverse_mass_matrix)

    def neg_energy_of(qp):
        return -total_energy_of_qp(qp, potential_energy, ke)

    depth = initial_tree.depth
    if active is None:
        active = torch.ones_like(initial_tree.turning)
    max_num_steps = torch.bitwise_left_shift(torch.ones_like(depth), depth)
    eps = _chain_scalar(step_size, depth.shape[0], depth.device)
    signed_eps = torch.where(go_right, eps, -eps)

    z = stepper(signed_eps, inverse_mass_matrix, _select(go_right, initial_tree.right, initial_tree.left))
    subtree = _leaf_tree(z, neg_energy_of(z), initial_neg_energy, max_energy_difference)
    stack_ = [z] + [None] * max_tree_depth
    count = torch.ones_like(depth)  # leaves built, a chain
    n = 1
    while True:
        alive = active & (count < max_num_steps) & ~subtree.turning & ~subtree.diverging
        if not bool(alive.any()):
            break
        z = _select(alive, stepper(signed_eps, inverse_mass_matrix, z), z)
        u = draws.uniform(alive)
        grown = _add_leaf_to_tree(u, subtree, z, go_right, neg_energy_of, initial_neg_energy,
                                  max_energy_difference)
        if n % 2 == 0:
            stack_[bin(n).count("1")] = z
            turning = torch.zeros_like(alive)
        else:
            i_max = bin(n - 1).count("1")
            i_min = i_max - _trailing_ones(n) + 1
            turning = torch.zeros_like(alive)
            for k in range(i_min, i_max + 1):
                turning = turning | is_euclidean_uturn(stack_[k], z)
        grown = grown._replace(turning=grown.turning | turning)
        subtree = _select(alive, grown, subtree)
        count = count + alive.to(count.dtype)
        n += 1
    # mark incomplete subtrees (aborted early) with depth -1
    return subtree._replace(depth=torch.where(count == max_num_steps, depth, -1))


def merge_trees(u, current_tree: Tree, new_subtree: Tree, go_right, bias_transition) -> Tree:
    """Merge an adjacent complete subtree into the trajectory, sampling the
    combined proposal progressively (biased toward the new subtree when
    ``bias_transition``, Betancourt's doubling scheme); ``u`` the uniforms
    of the choice."""
    logw_tot = torch.logaddexp(current_tree.logweight, new_subtree.logweight)
    denom = current_tree.logweight if bias_transition else logw_tot
    p_new = torch.clamp(torch.exp(new_subtree.logweight - denom), max=1.0)
    take_new = u < p_new
    left = _select(go_right, current_tree.left, new_subtree.left)
    right = _select(go_right, new_subtree.right, current_tree.right)
    return Tree(
        left=left,
        right=right,
        logweight=logw_tot,
        proposal_candidate=_select(take_new, new_subtree.proposal_candidate,
                                   current_tree.proposal_candidate),
        turning=is_euclidean_uturn(left, right),
        diverging=current_tree.diverging | new_subtree.diverging,
        depth=current_tree.depth + 1,
        cumulative_acceptance=current_tree.cumulative_acceptance
        + new_subtree.cumulative_acceptance,
    )


def generate_nuts_tree(
    initial_qp: QP,
    draws,
    step_size,
    max_tree_depth: int,
    stepper,
    potential_energy,
    kinetic_energy,
    inverse_mass_matrix,
    bias_transition: bool = True,
    max_energy_difference=math.inf,
) -> Tree:
    """One NUTS transition of each chain of the forest ``initial_qp``:
    double the trajectory in a random direction until a U-turn, a
    divergence or the depth cap, and return the multinomially sampled
    proposal and the diagnostics.  ``step_size`` is a number or ``(B,)``."""
    ke = partial(kinetic_energy, inverse_mass_matrix)
    initial_neg_energy = -total_energy_of_qp(initial_qp, potential_energy, ke)
    no = torch.zeros(initial_neg_energy.shape, dtype=torch.bool, device=initial_neg_energy.device)
    tree = Tree(
        left=initial_qp,
        right=initial_qp,
        logweight=initial_neg_energy,
        proposal_candidate=initial_qp,
        turning=no,
        diverging=no,
        depth=torch.zeros_like(no, dtype=torch.int64),
        cumulative_acceptance=torch.zeros_like(initial_neg_energy),
    )
    while True:
        active = (tree.depth < max_tree_depth) & ~tree.turning & ~tree.diverging
        if not bool(active.any()):
            return tree
        go_right = draws.direction(active)
        new_subtree = iterative_build_tree(
            draws, tree, step_size, go_right, stepper, potential_energy, kinetic_energy,
            inverse_mass_matrix, max_tree_depth, initial_neg_energy, max_energy_difference,
            active=active,
        )
        merge = active & (new_subtree.depth != -1) & ~new_subtree.turning & ~new_subtree.diverging
        merged = merge_trees(draws.uniform(merge), tree, new_subtree, go_right, bias_transition)
        # propagate the stop reason; depth bumps to terminate the loop
        stopped = tree._replace(
            turning=tree.turning | new_subtree.turning,
            diverging=tree.diverging | new_subtree.diverging,
            depth=tree.depth + 1,
            cumulative_acceptance=tree.cumulative_acceptance + new_subtree.cumulative_acceptance,
        )
        tree = _select(merge, merged, _select(active, stopped, tree))
