"""Symmetric-matrix functions mapped over tree leaves (counterpart of
``nifty_tpu/utils/tree_linalg.py``).

One mechanism covers every need of the full-covariance likelihood
(:class:`~..likelihood_impl.NDVariableCovarianceGaussian`): a spectral
function ``f(M) = U f(Λ) Uᵀ`` of a symmetric matrix through
``torch.linalg.eigh``, differentiated by the Daleckii–Krein formula

    dF = U (K ∘ (Uᵀ dM U)) Uᵀ,   K_ij = (f(λ_i) − f(λ_j)) / (λ_i − λ_j),
                                 K_ii = f'(λ_i),

stable where autograd through ``eigh`` blows up at (nearly) degenerate
eigenvalues.  The map is linear in dM and self-adjoint (K is symmetric),
so the same formula is the jvp (the metric pushes through it) and the
backward (KL and NUTS gradients pull through it).  Eigendirections with
non-positive eigenvalues are projected out, as in the reference, so a
slightly indefinite input degrades to its positive part, not to NaNs.

Every matrix leaf has shape ``(..., d, d)``: the leading axes are a batch
of ``eigh`` (on the card cuSOLVER's batched solver, in chunks of
:data:`EIGH_CHUNK` matrices).
Under ``torch.func.vmap`` the mapped axis joins that batch.
"""

from __future__ import annotations

import torch

from .tree import tree_map

__all__ = ["sym_inv", "sym_logm", "sym_solve", "sym_sqrtm"]

# matrices a call of ``torch.linalg.eigh``: cuSOLVER's batched solver
# (torch 2.11, CUDA 12.8, an H100) took 16,384 matrices of every order 2-32
# and refused 65,536 (CUSOLVER_STATUS_INVALID_VALUE in
# ``cusolverDnXsyevBatched_bufferSize``; ``bench/eigh_bench.py``)
EIGH_CHUNK = 1 << 14


def _eigh(M):
    """``torch.linalg.eigh`` of the ``(..., d, d)`` stack, in chunks of at
    most :data:`EIGH_CHUNK` matrices along the flattened leading axes."""
    flat = M.reshape((-1,) + tuple(M.shape[-2:]))
    if flat.shape[0] <= EIGH_CHUNK:
        return torch.linalg.eigh(M)
    parts = [torch.linalg.eigh(c) for c in flat.split(EIGH_CHUNK)]
    v = torch.cat([p[0] for p in parts]).reshape(tuple(M.shape[:-1]))
    return v, torch.cat([p[1] for p in parts]).reshape(M.shape)


def _valid(v):
    return v > torch.finfo(v.dtype).tiny


def _spectral_values(fn, v):
    ok = _valid(v)
    vs = torch.where(ok, v, 1.0)
    return ok, vs, torch.where(ok, fn(vs), 0.0)


def _compose(U, fv):
    return (U * fv.unsqueeze(-2)) @ U.mT


def _daleckii_krein(fn, dfn, v, U, dM):
    """``U (K ∘ (Uᵀ dM U)) Uᵀ`` at the eigensystem ``(v, U)``."""
    ok, vs, fv = _spectral_values(fn, v)
    vi, vj = vs.unsqueeze(-1), vs.unsqueeze(-2)
    dv = vi - vj
    close = dv.abs() < 1e-12 * (vi.abs() + vj.abs() + 1e-30)
    k_far = (fv.unsqueeze(-1) - fv.unsqueeze(-2)) / torch.where(close, 1.0, dv)
    K = torch.where(close, dfn(0.5 * (vi + vj)), k_far)
    K = torch.where(ok.unsqueeze(-1) & ok.unsqueeze(-2), K, 0.0)
    return U @ (K * (U.mT @ dM @ U)) @ U.mT


def _make_spectral(fn, dfn):
    """The spectral function of the scalar ``fn`` (derivative ``dfn``) as a
    :class:`torch.autograd.Function` of ``(..., d, d)`` leaves."""

    class Spectral(torch.autograd.Function):
        @staticmethod
        def forward(M):
            v, U = _eigh(M)
            return _compose(U, _spectral_values(fn, v)[2]), v, U

        @staticmethod
        def setup_context(ctx, inputs, output):
            _, v, U = output
            ctx.mark_non_differentiable(v, U)
            ctx.save_for_backward(v, U)
            ctx.save_for_forward(v, U)

        @staticmethod
        def backward(ctx, grad, _gv, _gU):
            v, U = ctx.saved_tensors
            return _daleckii_krein(fn, dfn, v, U, grad)

        @staticmethod
        def jvp(ctx, dM):
            v, U = ctx.saved_tensors
            return _daleckii_krein(fn, dfn, v, U, dM), None, None

        @staticmethod
        def vmap(info, in_dims, M):
            # the matrices are batched over their leading axes already
            return Spectral.apply(M.movedim(in_dims[0], 0)), (0, 0, 0)

    return lambda M: Spectral.apply(M)[0]


_sqrtm_leaf = _make_spectral(torch.sqrt, lambda v: 0.5 / torch.sqrt(v))
_logm_leaf = _make_spectral(torch.log, lambda v: 1.0 / v)
_inv_leaf = _make_spectral(lambda v: 1.0 / v, lambda v: -1.0 / v**2)


def sym_sqrtm(M):
    """Principal square root of symmetric PSD matrix leaves ``(..., d, d)``."""
    return tree_map(_sqrtm_leaf, M)


def sym_logm(M):
    """Matrix logarithm of symmetric positive-definite matrix leaves."""
    return tree_map(_logm_leaf, M)


def sym_inv(M):
    """(Pseudo-)inverse of symmetric PSD matrix leaves."""
    return tree_map(_inv_leaf, M)


def sym_solve(A, B, *, matrix_eqn: bool = False, transposed: bool = False):
    """Solve ``A X = B`` for symmetric positive-definite ``A`` per leaf:
    ``B`` leaves are stacks of vectors ``(..., d)``, or of matrices ``(...,
    d, d)`` with ``matrix_eqn``; ``transposed`` solves ``Aᵀ Xᵀ = Bᵀ``."""
    if transposed:
        A = tree_map(lambda a: a.mT, A)
        B = tree_map(lambda b: b.mT, B)
    Ainv = sym_inv(A)
    if matrix_eqn:
        out = tree_map(torch.matmul, Ainv, B)
    else:
        out = tree_map(lambda ai, b: (ai @ b.unsqueeze(-1)).squeeze(-1), Ainv, B)
    if transposed:
        out = tree_map(lambda x: x.mT, out)
    return out
