"""Re-balance an excitation against its amplitude (counterpart of
``nifty_tpu/adjust_variances.py``).

Given φ = A(θ)·ξ, the variation of ξ that the amplitude could carry is
moved into θ: an inverse-gamma Hamiltonian of |A|² against the fixed
|φ|² is minimised over θ by Newton-CG, and ξ is recomputed as φ / A_new,
so φ is kept exactly.
"""

from __future__ import annotations

from typing import Callable, Mapping, Optional, Sequence

from .likelihood import StandardHamiltonian
from .likelihood_impl import InverseGamma
from .optimize import newton_cg

__all__ = ["adjust_variances"]


def adjust_variances(
    position: Mapping,
    amplitude: Callable,
    xi_key: str,
    *,
    amplitude_keys: Optional[Sequence[str]] = None,
    scaling: Optional[float] = None,
    minimize_kwargs: Optional[dict] = None,
):
    """``position`` adjusted so that ξ = ``position[xi_key]`` is closer to
    white noise.

    ``amplitude(position)`` returns the amplitude A, broadcastable against
    ξ.  ``amplitude_keys`` are the entries of ``position`` the
    minimisation may move (every key but ``xi_key`` by default);
    ``minimize_kwargs`` go to :func:`~.optimize.newton_cg` (25 steps,
    ``xtol`` 1e-5 by default).  Returns the new position (a dict), with
    A_new·ξ_new = A·ξ."""
    position = dict(position)
    phi = amplitude(position) * position[xi_key]
    d = (phi.conj() * phi).real
    if amplitude_keys is None:
        amplitude_keys = [k for k in position if k != xi_key]
    amplitude_keys = list(amplitude_keys)
    frozen = {k: v for k, v in position.items() if k not in amplitude_keys}

    def x_of(theta):
        a = amplitude({**frozen, **theta})
        x = (a.conj() * a).real
        return x if scaling is None else scaling * x

    ham = StandardHamiltonian(InverseGamma(d / 2.0).amend(x_of))
    kw = dict(maxiter=25, xtol=1e-5)
    kw.update(minimize_kwargs or {})
    res = newton_cg(fun=ham, x0={k: position[k] for k in amplitude_keys}, **kw)
    new_pos = {**position, **res.x}
    new_pos[xi_key] = phi / amplitude(new_pos)
    return new_pos
