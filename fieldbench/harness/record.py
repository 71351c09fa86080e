"""The record of one checked step: what the window's CG solves were handed
and what they returned.

The harness hands the program's solvers a CG of its own choosing through
their public ``cg=`` arguments: :meth:`Recorder.wrap` of the program's
``static_cg``.  It records nothing but, in the armed step, copies each
solve's right-hand side ``j``, start ``x0``, every matrix application's
input ``d`` and output ``q``, and the result ``x`` into a pool allocated
before the window, so that the step's memory peak is the program's plus
the pool's, which :attr:`Recorder.pool_bytes` lets the harness take off."""

from __future__ import annotations

import inspect

import torch

__all__ = ["Recorder"]


def _leaves(tree):
    if tree is None:
        return []
    if isinstance(tree, dict):
        return list(tree.values())
    return [tree]


class Recorder:
    def __init__(self):
        self.mode = None  # None, "measure" (count the bytes) or "record"
        self.log = []
        self.need = 0  # float32 elements a recorded step takes
        self.pool = None
        self.cursor = 0

    @property
    def pool_bytes(self):
        return 0 if self.pool is None else self.pool.numel() * self.pool.element_size()

    def allocate(self, device):
        """The pool for one step of the size that ``measure`` counted."""
        self.pool = torch.empty(self.need, dtype=torch.float32, device=device)

    def keep(self, tree):
        if tree is None or self.mode is None:
            return None
        if self.mode == "measure":
            self.need += sum(v.numel() for v in _leaves(tree))
            return None

        def put(v):
            n = v.numel()
            if self.cursor + n > self.pool.numel():
                raise RuntimeError("the checked step outgrew the record's pool")
            out = self.pool[self.cursor: self.cursor + n].view(v.shape)
            out.copy_(v.detach())
            self.cursor += n
            return out

        return {k: put(v) for k, v in tree.items()} if isinstance(tree, dict) else put(tree)

    def arm(self, mode):
        self.mode, self.log, self.cursor = mode, [], 0

    def disarm(self):
        self.mode = None

    def wrap(self, cg):
        """``cg`` (a batched-capable solver ``cg(mat, j, x0=None, **kw)``)
        with its calls recorded while armed."""
        rec = self

        def recorded_cg(mat, j, x0=None, *, batched=False, **kw):
            if rec.mode is None:
                return cg(mat, j, x0=x0, batched=batched, **kw)
            call = {"batched": batched, "j": rec.keep(j), "x0": rec.keep(x0), "d": [], "q": []}

            def applied(t):
                q = mat(t)
                call["d"].append(rec.keep(t))
                call["q"].append(rec.keep(q))
                return q

            res = cg(applied, j, x0=x0, batched=batched, **kw)
            call["x"] = rec.keep(res.x)
            rec.log.append(call)
            return res

        recorded_cg.__signature__ = inspect.signature(cg)
        return recorded_cg
