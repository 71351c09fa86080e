"""What decides ``correct``: the checked step's record against the reference.

Twenty CG iterations over an ill-conditioned metric amplify rounding
without bound: two float64 implementations of the same solve part by 1e-4
after 20 steps, a float32 one by several per cent.  So the reference does
not solve beside the program and compare answers.  It follows the
program's solves step by step from the program's own state and checks each
stage by itself:

- the start: each solve's right-hand side and first iterate against the
  reference's own (the seed's vectors; for a draw, ``Jᵀ √λ d̃ + ξ̃`` and
  ``ξ̃`` from the sample's key; for the KL's Newton step, the gradient of
  the sample-averaged energy at the program's position and samples);
- every matrix application the solve made: the program's output against
  the reference metric applied to the same input, leaf by leaf.  How far
  float32 can compute a leaf depends on the position and on the leaf (the
  metric's range grows with the rate ``λ = exp(s)``, which a seed can make
  10⁵; a scalar leaf's pull-back is a sum over every pixel): so each leaf's
  largest gap is read in units of the largest gap of the plain float32
  reference on that leaf over the same inputs, floored at a rounding unit
  of the leaf.  ``apply_ratio`` is the second widest leaf's: one leaf, the
  zero mode's, reads from 1 to 10⁵ such units by the seed, because the
  program forms its pull-back as the difference of two sums over every
  mode (``azm · (a / azm)``), which cancel in all but the zero mode's
  term, and keeps float32's rounding of those sums; every leaf's reading
  is printed;
- the solver: the iterations it made, as many as the mix declares
  (``cg_iterations_off``), the first along the start's residual and each
  next one conjugate to the last through the program's own application
  (``direction_gap``);
  and a float64 replay that steps along the program's own directions to the
  minimum of the solve's energy, whose answer must be the program's;
- the step's output: the samples as the draws' answers, mirrored, and the
  step to the new position as the reference's line search along the
  program's Newton direction, its energies in float64 (the step's gap read
  against the step, or against a 4,096th of the position where that is
  larger).

Each gap but the applications' and the directions' is ``‖got − want‖ /
‖want‖`` over the whole position, every leaf together.  ``state_gap`` is
the largest of the starts', the answers', the samples' and the step's.  ``apply_ratio``,
``direction_gap``, ``cg_iterations_off`` and ``state_gap`` are compared
with the cell's limits."""

from __future__ import annotations

import torch

from ..reference.inference import Posterior, axpy, vdot
from ..reference.field import Field
from ..reference.precision import Precision
from .steps import KL_NEWTON_STEPS

__all__ = ["judge"]


def _f64(tree):
    if isinstance(tree, dict):
        return {k: v.double() for k, v in tree.items()}
    return tree.double()


def _f32(tree):
    return {k: v.float() for k, v in tree.items()}


def _sample(tree, b, batched):
    if tree is None:
        return None
    return {k: v[b] for k, v in tree.items()} if batched else tree


def sequences(call):
    """A CG call's record as one sequence a sample."""
    n = next(iter(call["j"].values())).shape[0] if call["batched"] else 1
    return [{key: _sample(call[key], b, call["batched"]) for key in ("j", "x0", "x")}
            | {"d": [_sample(d, b, call["batched"]) for d in call["d"]],
               "q": [_sample(q, b, call["batched"]) for q in call["q"]]}
            for b in range(n)]


def _rel(a, b):
    num = sum(float(torch.sum((a[k] - b[k]) ** 2)) for k in a)
    den = sum(float(torch.sum(b[k] ** 2)) for k in a)
    return (num / max(den, 1e-300)) ** 0.5


def _leaf_gaps(got, want):
    """``{leaf: ‖got − want‖ / ‖want‖}``."""
    return {k: _rel({k: got[k]}, {k: want[k]}) for k in want}


def _cos(a, b):
    return abs(float(vdot(a, b))) / max(float(vdot(a, a) * vdot(b, b)) ** 0.5, 1e-300)


def follow(seq):
    """Follow a solve's record (``seq``: its right-hand side, start,
    applications and answer) as CG in float64: ``(iterations, direction
    gap, answer gap, start gap)``.

    Each application is the start's (``x0`` itself, first), a new
    direction, a refresh of the residual at the iterate, or a repeated
    direction: a sample that the solver has stopped, after which nothing
    counts.  The first direction must be the start's residual ``M x0 − j``
    (``−j`` without a start), and each next one conjugate to the last,
    ``⟨d_{k+1}, M d_k⟩ = 0``, read as the cosine of ``d_{k+1}`` and the
    program's ``M d_k`` (a refresh in between resets the residual that the
    next direction is built from, and it is not read).  The replay steps
    from its iterate along each direction ``d`` to the minimum of the
    solve's energy ``½⟨x, Mx⟩ − ⟨j, x⟩``: ``α = (⟨x, M d⟩ − ⟨j, d⟩) / ⟨d, M
    d⟩``, with ``M d`` the program's application (``M`` symmetric), which
    leaves no rounding to carry from step to step; the answer must be its
    last iterate."""
    j = _f64(seq["j"])
    calls = ((_f64(d), _f64(q)) for d, q in zip(seq["d"], seq["q"]))  # one at a time in float64
    start_gap = 0.0
    if seq["x0"] is not None:
        x = _f64(seq["x0"])
        d, q = next(calls)
        start_gap = _rel(d, x)
        r = axpy(-1.0, j, q)
    else:
        x = {key: torch.zeros_like(v) for key, v in j.items()}
        r = {key: -v for key, v in j.items()}
    prev = prev_q = None
    iterations, direction_gap = 0, 0.0
    for d, q in calls:
        if prev is None:
            direction_gap = _rel(d, r)
        elif _rel(d, prev) == 0.0:
            break  # the sample has stopped
        elif _rel(d, x) < 1e-2:  # the residual's refresh at the iterate
            prev_q = None
            continue
        elif prev_q is not None:
            direction_gap = max(direction_gap, _cos(d, prev_q))
        iterations += 1
        x = axpy(-(vdot(x, q) - vdot(j, d)) / vdot(d, q), d, x)
        prev, prev_q = d, q
    return iterations, direction_gap, _rel(_f64(seq["x"]), x), start_gap


class Judge:
    """The reference posterior of the cell in float64 and in plain float32,
    and the gaps it reads."""

    FLOOR = 2.0**-24  # a float32 rounding unit of a leaf

    def __init__(self, config, data, device):
        model = config["model"]
        self.post = Posterior(Field(model, device, Precision("float64")), data)
        self.post32 = Posterior(Field(model, device, Precision("float32")), data)
        self.gaps = {}  # stage -> the largest gap read there
        self.leaf, self.leaf32 = {}, {}  # leaf -> the largest apply gap, the program's and float32's
        self.off = 0  # the most iterations a solve made off its declared count

    def note(self, stage, gap):
        self.gaps[stage] = max(self.gaps.get(stage, 0.0), gap)

    def solve(self, what, seq, mats, iterations, rhs=None, x0=None):
        """Judge one solve (``what``), declared ``iterations`` CG steps,
        against the metrics ``mats`` (float64, float32) and, where given,
        the reference's right-hand side and start."""
        mat, mat32 = mats
        if rhs is not None:
            self.note(f"{what}.rhs", _rel(_f64(seq["j"]), rhs))
        if x0 is not None:
            self.note(f"{what}.x0", _rel(_f64(seq["x0"]), x0))
        for d, q in zip(seq["d"], seq["q"]):
            want = mat(_f64(d))
            for side, got in ((self.leaf, _f64(q)), (self.leaf32, _f64(mat32(_f32(d))))):
                for k, g in _leaf_gaps(got, want).items():
                    side[k] = max(side.get(k, 0.0), g)
        made, direction, answer, start = follow(seq)
        self.off = max(self.off, abs(made - iterations))
        self.note(f"{what}.directions", direction)
        self.note(f"{what}.cg", max(answer, start))

    def numbers(self):
        ratios = {k: g / max(self.leaf32[k], self.FLOOR) for k, g in self.leaf.items()}
        for k, v in ratios.items():
            self.gaps[f"apply_ratio.{k}"] = v
        state = [v for k, v in self.gaps.items() if not k.startswith("apply") and "directions" not in k]
        return {"apply_ratio": sorted(ratios.values())[-2],
                "direction_gap": max(v for k, v in self.gaps.items() if k.endswith(".directions")),
                "cg_iterations_off": float(self.off),
                "state_gap": max(state)}


def judge_cg(judge, log, position, rhs, iterations):
    """The checked CG solve at ``position`` of right-hand side ``rhs``."""
    (call,) = log
    (seq,) = sequences(call)
    mats = judge.post.metric_at(_f64(position)), judge.post32.metric_at(_f32(position))
    judge.solve("solve", seq, mats, iterations, rhs=_f64(rhs))


def judge_vi(judge, log, out, keys, traffic):
    """The checked VI iteration: its draws, its samples, its Newton step."""
    post = judge.post
    x = _f64(out["pos_in"])
    draws = [s for call in log[: len(log) - KL_NEWTON_STEPS] for s in sequences(call)]
    if len(draws) != len(keys):
        raise RuntimeError(f"{len(draws)} draws for {len(keys)} keys")
    mats = post.metric_at(x), judge.post32.metric_at(_f32(x))
    residuals = []
    for seq, key in zip(draws, keys):
        white_d, white_p = post.white_noise(key, x)
        s, _, vjp = post.field.linearization(x)
        lsm = vjp(torch.sqrt(torch.exp(s)) * white_d)
        judge.solve("draw", seq, mats, int(traffic["draw_cg"]),
                    rhs={k: lsm[k] + white_p[k] for k in x}, x0=white_p)
        r = _f64(seq["x"])
        residuals += [r, {k: -v for k, v in r.items()}]
    pos_out = _f64(out["pos_out"])
    for got, r in zip(out["samples"], residuals):
        judge.note("samples", _rel({k: v - pos_out[k] for k, v in _f64(got).items()}, r))
    e0, grad = post.kl_energy_and_grad(x, residuals)
    (kl,) = sequences(log[-1])
    mats = post.kl_metric(x, residuals), judge.post32.kl_metric(_f32(x), [_f32(r) for r in residuals])
    judge.solve("newton", kl, mats, int(traffic["kl_cg"]), rhs=grad)
    step, scale = _f64(kl["x"]), 1.0
    for _ in range(6):
        cand = axpy(-scale, step, x)
        if sum(post.energy(axpy(1.0, cand, r)) for r in residuals) / len(residuals) <= e0:
            break
        scale /= 2.0
    else:
        cand = x
    # the step taken, judged against itself or a 4,096th of the position, the larger: a
    # float32 position rounds a step some 10⁻⁵ of it long by a few 10⁻³ of the step
    taken = vdot(axpy(-1.0, x, cand), axpy(-1.0, x, cand)) ** 0.5
    floor = 2.0**-12 * vdot(x, x) ** 0.5
    miss = vdot(axpy(-1.0, cand, pos_out), axpy(-1.0, cand, pos_out)) ** 0.5
    judge.note("step", float(miss / max(taken, floor)))


def judge(config, traffic, data, device, log, out, position=None, rhs=None, keys=None):
    """``({number: value}, {stage: gap})`` of the checked step."""
    j = Judge(config, data, device)
    with torch.no_grad():
        if traffic["kind"] == "cg":
            judge_cg(j, log, position, rhs, int(traffic["cg_iterations"]))
        else:
            judge_vi(j, log, out, keys, traffic)
    return j.numbers(), j.gaps
