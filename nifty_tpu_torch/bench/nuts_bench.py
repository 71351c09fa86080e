#!/usr/bin/env python3
"""Two choices on the NUTS path, each side timed in one process on one CUDA card.

Usage, from the root of a checkout::

    python3 nifty_tpu_torch/bench/nuts_bench.py [--samples 32]

1. One chain: ``hmc_oo.Potential`` as it is, a batch of one through
   plain autograd (``plain``), or with every batch through
   ``torch.func.vmap`` (``vmap``).
   Times ``chip_smoke.py`` phase 10b's row (``bench_extra.py:267-300``:
   the 64² field with 16 knots under a Gaussian, sigma 0.3, one
   ``NUTSChain``, step 0.05, depth <= 8; ``--samples`` transitions after
   one warm-up) and one ``chain_map="lmap"`` transition of 4 chains on
   phase 10's 1280² exact Poisson model (depth <= 5, step 5e-4, from the
   latent that drew the counts), in the order plain, vmap, vmap, plain.
2. The integrated Wiener process's cumsums accumulated in float64 (``f64``)
   or in the field's float32 (``f32``), at the 4 chains' last samples of
   phase 10's ``nuts_sample`` (seed 21, 8 warm-up and 4 samples, depth <= 5,
   step 1e-3): the batched gradient's ms (CUDA events, median of 10 after
   one warm-up) and its relative L2 error a chain against plain autograd
   in float64 on the CPU, in the order f64, f32, f32, f64; beside them the
   errors of a plain float32 gradient, on the card a chain at a time and
   on the CPU; and the IWP alone over phase 10's 127,080 |k| bins, 4
   excitations under ``torch.func.vmap``, against float64.

Prints one JSON line per run, then the card's ``nvidia-smi`` name and
power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("nuts_bench: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.getcwd())
    import nifty_tpu_torch as nt
    from nifty_tpu_torch import hmc_oo
    from nifty_tpu_torch.bench import workload
    from nifty_tpu_torch.models import gauss_markov

    ap = argparse.ArgumentParser()
    ap.add_argument("--samples", type=int, default=32)
    args = ap.parse_args()
    dev = torch.device("cuda")

    class VmapPotential(hmc_oo.Potential):
        """Every batch through ``torch.func.vmap``, a batch of one too."""

        def energy(self, x):
            return self._energy(x)

        def gradient(self, x):
            return self._gradient(x)

    # the 64² row
    n = 64
    cfm = nt.CorrelatedFieldMaker("cf")
    cfm.set_amplitude_total_offset(offset_mean=0.0, offset_std=(1e-1, 3e-2))
    cfm.add_fluctuations((n, n), distances=1.0 / n, fluctuations=(1.0, 5e-1),
                         loglogavgslope=(-3.0, 2e-1), flexibility=None, n_mode_knots=16)
    cf = cfm.finalize(device=dev, dtype=torch.float32)
    with torch.no_grad():
        truth = cf(nt.position_from_numpy(cf, workload.latent_draw(cf.domain, 4)))
    data = (truth.double().cpu().numpy() + 0.3 * np.random.default_rng(5).normal(size=(n, n)))
    ham = nt.StandardHamiltonian(nt.Gaussian(data.astype(np.float32),
                                             noise_std_inv=lambda x: (1 / 0.3) * x, device=dev).amend(cf))
    row_start = nt.position_from_numpy(cf, workload.latent_draw(cf.domain, 6))
    # phase 10's model, 4 chains
    lh, _ = workload.build_vi_likelihood(1280, dev, torch.float32, None)
    truth_np = workload.latent_draw(lh.forward_model.domain, 0)
    proto = nt.position_from_numpy(lh.forward_model, truth_np)
    chains = nt.position_from_numpy(lh.forward_model, {
        k: np.repeat(v[None], 4, axis=0) for k, v in truth_np.items()}, batch=(4,))
    potential = lambda q: -nt.LogDensity(lh)(q)  # noqa: E731
    keys = nt.evi.seeds(torch.Generator().manual_seed(21), 4)

    def one_chain(variant):
        hmc_oo.Potential = {"plain": base, "vmap": VmapPotential}[variant]
        try:
            row = nt.NUTSChain(ham, 1.0, row_start, step_size=0.05, max_tree_depth=8)
            _, (draws, pos) = row.generate_n_samples(7, row_start, 1)  # warm-up
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out, _ = row.generate_n_samples(draws, pos, args.samples)
            torch.cuda.synchronize()
            row_s = time.perf_counter() - t0
            chain = nt.NUTSChain(potential, 1.0, proto, step_size=5e-4, max_tree_depth=5)
            t0 = time.perf_counter()
            lm, _ = chain.generate_n_samples(keys, chains, 1, chain_map="lmap")
            torch.cuda.synchronize()
            lmap_s = time.perf_counter() - t0
        finally:
            hmc_oo.Potential = base
        print(json.dumps({"bench": "one_chain", "potential": variant, "row_samples": args.samples,
                          "row_samples_per_s": args.samples / row_s,
                          "row_tree_depths": out.depths.tolist(),
                          "lmap_transition_s": lmap_s, "lmap_depths": lm.depths[:, 0].tolist()}),
              flush=True)

    cumsums = {"f64": gauss_markov._cumsum, "f32": lambda x: torch.cumsum(x, 0)}
    _, info = nt.nuts_sample(lh, 21, n_chains=4, n_samples=4, n_warmup=8, initial_position=chains,
                             max_tree_depth=5, step_size=1e-3)
    last = {k: v[:, -1] for k, v in info["chain_samples"].items()}
    ravel = hmc_oo.Ravel(proto)
    x_last = ravel.ravel(last)

    def plain_gradient(lh_, dtype, device):
        out = []
        for c in range(4):
            q = {k: v[c].to(device, dtype).requires_grad_(True) for k, v in last.items()}
            g = torch.autograd.grad(-nt.LogDensity(lh_)(q), list(q.values()))
            out.append(ravel.ravel({k: v.unsqueeze(0) for k, v in zip(q, g)})[0].double().cpu())
        return torch.stack(out)

    def rel_err(g, ref):
        return (torch.linalg.norm(g.double().cpu() - ref, dim=1) / torch.linalg.norm(ref, dim=1)).tolist()

    data = lh.likelihood.data.cpu()
    ref = plain_gradient(nt.Poissonian(data, device="cpu").amend(nt.ChainModel(
        torch.exp, workload.bench_field(1280, "cpu", torch.float64, None))), torch.float64, "cpu")
    cpu32 = plain_gradient(nt.Poissonian(data, device="cpu").amend(nt.ChainModel(
        torch.exp, workload.bench_field(1280, "cpu", torch.float32, None))), torch.float32, "cpu")
    print(json.dumps({"bench": "plain_gradient_error", "chains": 4, "n": 1280,
                      "card_rel_l2": rel_err(plain_gradient(lh, torch.float32, dev), ref),
                      "cpu_f32_rel_l2": rel_err(cpu32, ref)}), flush=True)

    def gradient_ms(variant):
        gauss_markov._cumsum = cumsums[variant]
        try:
            grad = VmapPotential(potential, ravel).gradient
            err = rel_err(grad(x_last), ref)
            times = []
            for _ in range(10):
                s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                s.record()
                grad(x_last)
                e.record()
                torch.cuda.synchronize()
                times.append(s.elapsed_time(e))
        finally:
            gauss_markov._cumsum = cumsums["f64"]
        print(json.dumps({"bench": "batched_gradient", "cumsum": variant, "chains": 4, "n": 1280,
                          "ms_median": float(np.median(times)), "ms_all": times,
                          "rel_l2_vs_cpu_f64": err}), flush=True)

    def iwp_error(variant):
        gauss_markov._cumsum = cumsums[variant]
        rng = np.random.default_rng(3)
        u = 127_080
        xi = torch.from_numpy(rng.standard_normal((4, u, 2)))
        x0 = torch.tensor([0.3, -1.0], dtype=torch.float64)
        dt = torch.from_numpy(rng.uniform(1e-5, 1.1e-4, u))

        def iwp(x, x0, dt):
            return gauss_markov.integrated_wiener_process(
                x, x0, torch.tensor(0.7, dtype=x.dtype), dt, torch.tensor(0.1, dtype=x.dtype))

        try:
            want = torch.stack([iwp(x, x0, dt) for x in xi])
            f32 = lambda t: t.to(dev, torch.float32)  # noqa: E731
            got = torch.func.vmap(lambda x: iwp(x, f32(x0), f32(dt)))(f32(xi)).double().cpu()
        finally:
            gauss_markov._cumsum = cumsums["f64"]
        print(json.dumps({"bench": "iwp_error", "cumsum": variant, "bins": u, "batch": 4,
                          "rel_l2_vs_f64": float(torch.linalg.norm(got - want) / torch.linalg.norm(want))}),
              flush=True)

    base = hmc_oo.Potential
    for variant in ("plain", "vmap", "vmap", "plain"):
        one_chain(variant)
    for variant in ("f64", "f32", "f32", "f64"):
        gradient_ms(variant)
    for variant in ("f64", "f32"):
        iwp_error(variant)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
