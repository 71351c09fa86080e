"""The checks of demos 8 and 11 over a range of seeds, on the CPU.

Demo 8's check is the L1 distance of the recovered density to the
empirical one (below 0.35), demo 11's the matched prior's ELBO less the
stiff one's (above 0).  Their MGVI fits depend on the start and the noise
draws, and a seed picks both, so this prints each seed's value and counts
the seeds whose check holds.  ``--stream generator`` draws the samples'
white noise from a ``torch.Generator`` seeded by the sample's key, as the
port did before the counter-based K7, to tell a property of the demo from
one of the draw; ``--iterations`` sets demo 8's fast iterations and
``--starts`` demo 11's starts::

    python demos_torch/seed_sweep.py 8 --seeds 6 29 --fast [--iterations 2]
    python demos_torch/seed_sweep.py 11 --seeds 31 45 [--starts 1] [--stream generator]

Each seed runs in a process of its own, ``--jobs`` at a time, with one
thread each.
"""

import argparse
import importlib.util
import json
import os
import sys
from concurrent.futures import ProcessPoolExecutor
from functools import partial
import multiprocessing

HERE = os.path.dirname(os.path.abspath(__file__))
DEMOS = {"8": "8_density_estimator.py", "11": "11_model_comparison.py"}


def _generator_white_noise(likelihood, pos, key, point_estimates=()):
    """``evi.white_noise`` as it drew before K7, unsharded: the data's
    draws, then the position's, from one ``torch.Generator``."""
    import torch
    from torch.utils._pytree import tree_leaves

    from nifty_tpu_torch import evi
    from nifty_tpu_torch.utils.tree import ShapeWithDtype, random_like, tree_map

    lh, p_liquid = likelihood.freeze(primals=pos, point_estimates=point_estimates)
    leaf = tree_leaves(p_liquid)[0]
    draw = partial(random_like, torch.Generator(device=leaf.device).manual_seed(int(key)),
                   device=leaf.device)
    data = draw(tree_map(lambda s: ShapeWithDtype(s.shape, s.dtype or leaf.real.dtype),
                         lh.lsm_tangents_shape, is_leaf=lambda x: isinstance(x, ShapeWithDtype)))
    return evi.WhiteNoise(data, draw(tree_map(ShapeWithDtype.from_leave, p_liquid)))


def _one(args, seed):
    import numpy as np
    import torch

    torch.set_num_threads(1)
    sys.path.insert(0, os.path.dirname(HERE))
    from nifty_tpu_torch import evi

    if args.stream == "generator":
        evi.white_noise = _generator_white_noise
    spec = importlib.util.spec_from_file_location(f"demo{args.demo}", os.path.join(HERE, DEMOS[args.demo]))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    if args.iterations is not None:
        mod.FAST_ITERATIONS = args.iterations
    if args.starts is not None:
        mod.STARTS = args.starts
    out = mod.run("cpu", fast=args.fast, seed=seed)
    if args.demo == "8":
        value = mod.l1(out)
        return seed, value, value < 0.35
    value = out["elbo"]["matched (-3)"] - out["elbo"]["stiff (-6)"]
    return seed, float(np.float64(value)), value > 0


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("demo", choices=sorted(DEMOS))
    parser.add_argument("--seeds", type=int, nargs=2, required=True, metavar=("FIRST", "LAST"))
    parser.add_argument("--fast", action="store_true")
    parser.add_argument("--iterations", type=int, default=None, help="demo 8's fast iterations")
    parser.add_argument("--starts", type=int, default=None, help="demo 11's starts")
    parser.add_argument("--stream", choices=("k7", "generator"), default="k7")
    parser.add_argument("--jobs", type=int, default=4)
    args = parser.parse_args(argv)
    seeds = range(args.seeds[0], args.seeds[1] + 1)
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(args.jobs, mp_context=ctx) as pool:
        rows = list(pool.map(partial(_one, args), seeds))
    for seed, value, ok in rows:
        print(json.dumps({"seed": seed, "value": value, "holds": bool(ok)}))
    failed = [seed for seed, _, ok in rows if not ok]
    print(json.dumps({"demo": args.demo, "fast": args.fast, "stream": args.stream,
                      "iterations": args.iterations, "starts": args.starts,
                      "seeds": [seeds[0], seeds[-1]], "held": len(rows) - len(failed), "failed": failed}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
