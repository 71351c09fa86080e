"""HMC and NUTS chains (counterpart of ``nifty_tpu/hmc_oo.py``).

A chain run is a host loop over transitions.  :meth:`_Sampler.
generate_n_samples` runs one chain (an integer key, a position without a
chain axis) or several (a sequence of keys, a position with a leading
chain axis), where the JAX package's users ``jax.vmap`` the call:
``chain_map="vmap"`` runs the chains as one batch, so the potential's
energy and gradient go through ``torch.func.vmap`` and every kernel
launches once per batch; ``"lmap"`` runs them one after another as
batches of one.  Chain ``c`` draws from its own generator, seeded with
its key, so both maps give the same chains.

Inside a run a chain's position and momentum are its tree's leaves laid
end to end (:class:`Ravel`), a ``(B, D)`` tensor for B chains, so the
tree's masked updates are one tensor operation each; the
potential sees the tree.  The position's leaves share one dtype.
"""

from __future__ import annotations

import math
from functools import partial
from typing import Any, Callable, NamedTuple, Union

import numpy as np
import torch
from torch.utils._pytree import tree_flatten, tree_leaves, tree_structure, tree_unflatten

from .hmc import (
    QP,
    ChainDraws,
    Tree,
    generate_hmc_acc_rej,
    generate_nuts_tree,
    leapfrog_step,
)
from .utils.tree import ShapeWithDtype, get_map, tree_map

__all__ = ["Chain", "HMCChain", "NUTSChain", "Potential", "Ravel", "kinetic_energy", "map_chains"]


def _parse_diag_mass_matrix(mass_matrix, position_proto):
    """Broadcast a number, or a tree matching the position, onto the
    position tree (a tree of tensors)."""
    if isinstance(mass_matrix, (float, int)) or (
        isinstance(mass_matrix, torch.Tensor) and mass_matrix.ndim == 0
    ):
        return tree_map(
            lambda x: torch.full(x.shape, float(mass_matrix), dtype=x.dtype, device=x.device),
            position_proto,
        )
    if tree_structure(mass_matrix) != tree_structure(position_proto):
        raise TypeError("mass matrix tree does not match the position tree")
    return tree_map(lambda m, x: torch.broadcast_to(m, x.shape), mass_matrix, position_proto)


class Ravel:
    """The leaves of a position tree (tensors or :class:`ShapeWithDtype`)
    laid end to end along a last axis of length ``size``."""

    def __init__(self, proto):
        leaves, self.spec = tree_flatten(proto, is_leaf=lambda x: isinstance(x, ShapeWithDtype))
        self.shapes = [tuple(x.shape) for x in leaves]
        self.sizes = [math.prod(s) for s in self.shapes]
        self.size = sum(self.sizes)

    def ravel(self, forest):
        """``(B, size)`` of a forest with one leading axis."""
        return torch.cat([x.reshape(x.shape[0], -1) for x in tree_leaves(forest)], dim=1)

    def unravel(self, flat):
        """The tree (with ``flat``'s leading axes) of ``(..., size)``."""
        lead = tuple(flat.shape[:-1])
        parts = torch.split(flat, self.sizes, dim=-1)
        return tree_unflatten([p.reshape(lead + s) for p, s in zip(parts, self.shapes)], self.spec)

    def unravel_qps(self, obj):
        """``obj`` with the position and momentum of every :class:`QP` in it
        (a tree of named tuples, as :class:`~.hmc.Tree`) unravelled."""
        if isinstance(obj, QP):
            return QP(self.unravel(obj.position), self.unravel(obj.momentum))
        if isinstance(obj, tuple) and hasattr(obj, "_fields"):
            return type(obj)(*(self.unravel_qps(x) for x in obj))
        return obj


class Potential:
    """A potential energy of one position (a tree), evaluated on raveled
    chains ``(B, D)``: ``energy`` (``(B,)``) and ``gradient`` (``(B, D)``),
    each one batched call, ``torch.func.vmap`` of ``potential_energy`` and
    of its ``torch.func.grad``.  A batch of one calls it (and autograd)
    plainly: ``vmap``'s host work at B = 1 halves a lone chain's rate
    (``bench/nuts_bench.py``)."""

    def __init__(self, potential_energy: Callable, ravel: Ravel):
        self.potential_energy = potential_energy

        def flat(v):
            return potential_energy(ravel.unravel(v))

        self._flat = flat
        self._energy = torch.func.vmap(flat, randomness="error")
        self._gradient = torch.func.vmap(torch.func.grad(flat), randomness="error")

    def energy(self, x):
        if x.shape[0] == 1:
            with torch.no_grad():
                return self._flat(x[0]).unsqueeze(0)
        return self._energy(x)

    def gradient(self, x):
        if x.shape[0] == 1:
            v = x[0].detach().requires_grad_(True)
            with torch.enable_grad():
                (g,) = torch.autograd.grad(self._flat(v), v)
            return g.unsqueeze(0)
        return self._gradient(x)


def kinetic_energy(inverse_mass_matrix, momentum):
    """``½ pᵀ M⁻¹ p`` a chain of a forest, ``(B,)``, accumulated in
    float64."""
    terms = [
        torch.sum((m * p.real**2 / 2.0).reshape(p.shape[0], -1), dim=-1, dtype=torch.float64)
        for m, p in zip(tree_leaves(inverse_mass_matrix), tree_leaves(momentum))
    ]
    return sum(terms[1:], terms[0])


def _kinetic_energy_gradient(inverse_mass_matrix, momentum):
    return tree_map(torch.mul, inverse_mass_matrix, momentum)


def make_stepper(potential: Potential):
    """The leapfrog step of ``potential`` with a diagonal mass matrix."""
    return partial(leapfrog_step, potential.gradient, _kinetic_energy_gradient)


def _cat(outs):
    """Concatenate the per-chain outputs of :func:`map_chains` along their
    leading axis (``None`` stays)."""
    return tree_map(lambda *xs: None if xs[0] is None else torch.cat(xs), *outs)


def map_chains(chain_map, run, draws: ChainDraws, *forests):
    """``run(draws, *forests)`` over the chains: ``"vmap"`` calls it once
    on all of them; ``"lmap"`` (or ``"smap"``) once a chain, on batches of
    one, concatenating the outputs along their leading (chain) axis.
    ``"pmap"`` (chains across ranks) is not ported: a chain's tree is built
    on the host, one leaf at a time, so the ranks would wait on each other
    every leaf (ROADMAP.md)."""
    spec = str(chain_map).lower()
    if spec == "vmap":
        return run(draws, *forests)
    if spec == "pmap":
        raise NotImplementedError("chain_map 'pmap': chains across ranks are not ported "
                                  "(ROADMAP.md); use 'vmap' or 'lmap'")
    if spec not in ("lmap", "smap"):
        get_map(spec)  # raises for unknown maps
        raise ValueError(f"chain_map must be 'vmap' or 'lmap', not {chain_map!r}")
    return _cat([
        run(draws.chain(c), *(tree_map(lambda x, c=c: x[c:c + 1], f) for f in forests))
        for c in range(len(draws))
    ])


class Chain(NamedTuple):
    """Results of a chain run: each field with a leading sample axis, after
    a leading chain axis for several chains; ``acceptance`` averaged over
    the samples."""

    samples: Any
    divergences: torch.Tensor
    acceptance: Union[torch.Tensor, float]
    depths: torch.Tensor = None
    trees: Any = None


def _chain_draws(key, device) -> ChainDraws:
    """The draws of an integer key (one chain, ``batched`` False), a
    sequence of them, or the :class:`ChainDraws` a previous run returned."""
    if isinstance(key, ChainDraws):
        return key
    if isinstance(key, (int, np.integer)):
        draws = ChainDraws([key], device)
        draws.batched = False
        return draws
    return ChainDraws(list(key), device)


class _Sampler:
    def __init__(
        self,
        potential_energy: Callable,
        inverse_mass_matrix,
        position_proto,
        step_size: Union[float, torch.Tensor] = 1.0,
        max_energy_difference: Union[float, torch.Tensor] = math.inf,
    ):
        if not callable(potential_energy):
            raise TypeError("potential_energy must be callable")
        self.potential_energy = potential_energy
        self.ravel = Ravel(position_proto)
        self.potential = Potential(potential_energy, self.ravel)
        self.inverse_mass_matrix = _parse_diag_mass_matrix(inverse_mass_matrix, position_proto)
        self.mass_matrix_sqrt = tree_map(lambda m: m ** (-0.5), self.inverse_mass_matrix)
        self._inv_m = self.ravel.ravel(tree_map(lambda m: m.unsqueeze(0), self.inverse_mass_matrix))
        self.step_size = step_size
        self.max_energy_difference = max_energy_difference
        self.kinetic_energy = kinetic_energy
        self.stepper = make_stepper(self.potential)

    def _momentum(self, draws: ChainDraws):
        return draws.momentum((self._inv_m ** (-0.5)).expand(len(draws), -1))

    def sample_next_state(self, draws: ChainDraws, prev_position):
        raise NotImplementedError()

    def _run(self, draws, position, num_samples, save_intermediates):
        outs = []
        for _ in range(num_samples):
            info, position = self.sample_next_state(draws, position)
            outs.append(self._chain_entry(position, info, save_intermediates))
        # the chain axis first, then the samples
        out = tree_map(lambda *xs: None if xs[0] is None else torch.stack(xs, dim=1), *outs)
        return out, position

    def generate_n_samples(
        self,
        key,
        initial_position,
        num_samples: int,
        *,
        save_intermediates: bool = False,
        chain_map="vmap",
    ):
        """``num_samples`` transitions from ``initial_position``: ``(Chain,
        (draws, last position))``.  ``key`` is an integer seed (one chain,
        ``initial_position`` without a chain axis), a sequence of seeds (a
        chain each, ``initial_position`` with the chain axis) or the draws
        of a previous run, which it continues."""
        draws = _chain_draws(key, tree_leaves(initial_position)[0].device)
        several = draws.batched
        pos = initial_position if several else tree_map(lambda x: x.unsqueeze(0), initial_position)
        out, pos = map_chains(
            chain_map, lambda d, p: self._run(d, p, num_samples, save_intermediates), draws,
            self.ravel.ravel(pos),
        )
        chain = self._assemble_chain(out)
        chain = chain._replace(samples=self.ravel.unravel(chain.samples),
                               trees=self.ravel.unravel_qps(chain.trees))
        pos = self.ravel.unravel(pos)
        if not several:
            chain = Chain(*(None if f is None else tree_map(lambda x: x[0], f) for f in chain))
            pos = tree_map(lambda x: x[0], pos)
        return chain, (draws, pos)


class NUTSChain(_Sampler):
    """No-U-Turn sampler chain (multinomial, iterative tree building)."""

    def __init__(
        self,
        potential_energy,
        inverse_mass_matrix,
        position_proto,
        step_size=1.0,
        max_tree_depth: int = 10,
        bias_transition: bool = True,
        max_energy_difference=math.inf,
    ):
        super().__init__(potential_energy, inverse_mass_matrix, position_proto, step_size,
                         max_energy_difference)
        self.max_tree_depth = int(max_tree_depth)
        self.bias_transition = bias_transition

    def sample_next_state(self, draws: ChainDraws, prev_position):
        tree = generate_nuts_tree(
            QP(position=prev_position, momentum=self._momentum(draws)),
            draws,
            self.step_size,
            self.max_tree_depth,
            self.stepper,
            self.potential.energy,
            self.kinetic_energy,
            self._inv_m,
            bias_transition=self.bias_transition,
            max_energy_difference=self.max_energy_difference,
        )
        return tree, tree.proposal_candidate.position

    def _chain_entry(self, pos, tree: Tree, save_intermediates):
        n_prop = torch.clamp(torch.exp2(tree.depth.double()) - 1.0, min=1.0)
        return dict(
            sample=pos,
            divergence=tree.diverging,
            acceptance=tree.cumulative_acceptance / n_prop,
            depth=tree.depth,
            tree=tree if save_intermediates else None,
        )

    def _assemble_chain(self, out):
        return Chain(
            samples=out["sample"],
            divergences=out["divergence"],
            acceptance=out["acceptance"].mean(dim=-1),
            depths=out["depth"],
            trees=out["tree"],
        )


class HMCChain(_Sampler):
    """Plain HMC with a fixed number of leapfrog steps and Metropolis
    accept/reject."""

    def __init__(
        self,
        potential_energy,
        inverse_mass_matrix,
        position_proto,
        num_steps: int = 128,
        step_size=1.0,
        max_energy_difference=math.inf,
    ):
        super().__init__(potential_energy, inverse_mass_matrix, position_proto, step_size,
                         max_energy_difference)
        self.num_steps = int(num_steps)

    def sample_next_state(self, draws: ChainDraws, prev_position):
        acc_rej = generate_hmc_acc_rej(
            draws=draws,
            initial_qp=QP(position=prev_position, momentum=self._momentum(draws)),
            step_size=self.step_size,
            num_steps=self.num_steps,
            stepper=self.stepper,
            potential_energy=self.potential.energy,
            kinetic_energy=self.kinetic_energy,
            inverse_mass_matrix=self._inv_m,
            max_energy_difference=self.max_energy_difference,
        )
        return acc_rej, acc_rej.accepted_qp.position

    def _chain_entry(self, pos, acc_rej, save_intermediates):
        return dict(
            sample=pos,
            divergence=acc_rej.diverging,
            acceptance=acc_rej.accepted.double(),
            tree=acc_rej if save_intermediates else None,
        )

    def _assemble_chain(self, out):
        return Chain(
            samples=out["sample"],
            divergences=out["divergence"],
            acceptance=out["acceptance"].mean(dim=-1),
            depths=None,
            trees=out["tree"],
        )
