#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port's main path once on one NVIDIA GPU.

Usage: ``python3 chip_smoke.py`` from the root of a checkout, on a machine
with one CUDA card, ``nvcc`` and PyTorch built for CUDA.  It imports no
JAX.  Phases, each printing one JSON line to stdout:

1. device: requires CUDA; the card's name and power limit (nvidia-smi);
2. build: compiles ``nifty_tpu_torch/csrc/*.cu`` with nvcc (set-up time)
   and builds the 1280²- and 4096²-exact models on the host;
3. kernels: each hand-written kernel against its plain PyTorch version on
   the card, at the main path's shapes, with both times (CUDA events);
4. main path: ``Poissonian(data).amend(ChainModel(torch.exp, cf))`` with
   the exact-spectrum correlated field at 1280² and 4096², f32 on the
   card: the Fisher-metric apply, its median time, and at 1280² its
   agreement with the same model in f64 on the CPU;
5. cg: 20 conjugate-gradient iterations on (M + 1) x = b at 1280², the
   inner solve of an MGVI sample draw; the residual must fall below its
   value after the first iteration.

The launch counters are set to 0 just before phase 4 and read after
phase 5: every kernel must have launched there.  Then it prints the card
line, the kernel summary and, last, ``{"ok": true, "device": ...}``.  Any
failure raises, so the exit code is not 0 and no result line is printed.

Tolerances (and why): K1 exact (a gather computes nothing); K2 relative
1e-6 against a float64 segment sum (f32 sums over one bin in a fixed
order); Hartley max|Δ|/max|ref| <= 1e-5 (f32 FFT rounding); metric
relative L2 <= 1e-4 against float64 on the CPU (f32 through exp and
three Hartleys).  TF32 is off for matmuls and cuDNN, so no library call
rounds to 10-bit mantissas behind the comparison.
"""

from __future__ import annotations

import copy
import json
import os
import subprocess
import sys
import time

DEVICE = "cuda:0"
SHAPES_MAIN = (1280, 4096)
SHAPES_HARTLEY = (1280, 4096, 10240)
CG_ITERS = 20
TOL = {"k2": 1e-6, "hartley": 1e-5, "metric": 1e-4}  # K1 must be exact


def emit(obj):
    print(json.dumps(obj), flush=True)


def fail(msg):
    raise RuntimeError(msg)


def cuda_ms(fn, iters=20, warmup=3):
    """Mean device time of ``fn`` in ms over ``iters`` back-to-back calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def build_likelihood(nt, n, seed=42):
    """The bench's exact-spectrum row at n²: model and data on the host, f64."""
    import numpy as np
    import torch

    cfm = nt.CorrelatedFieldMaker("cf")
    cfm.set_amplitude_total_offset(offset_mean=1.0, offset_std=(1e-1, 3e-2))
    cfm.add_fluctuations(
        (n, n),
        distances=1.0 / n,
        fluctuations=(1.0, 5e-1),
        loglogavgslope=(-3.0, 2e-1),
        flexibility=(1e0, 2e-1),
    )
    cf = cfm.finalize()
    rng = np.random.default_rng(seed)
    pos = {k: rng.standard_normal(v.shape) for k, v in sorted(cf.domain.items())}
    data = rng.poisson(1.0, size=(n, n)).astype(np.int32)
    rng_t = np.random.default_rng(seed + 2)
    tan = {k: rng_t.standard_normal(v.shape) for k, v in sorted(cf.domain.items())}
    lh = nt.Poissonian(torch.from_numpy(data)).amend(nt.ChainModel(torch.exp, cf))
    return lh, pos, tan


def rel_max(a, b):
    return float((a - b).abs().max() / b.abs().max())


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs only on the card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import numpy as np

    import nifty_tpu_torch as nt
    from nifty_tpu_torch import native
    from nifty_tpu_torch.ops import cuda_expand as ce
    from nifty_tpu_torch.ops import cuda_fft as cfft

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(DEVICE)

    # -- 1. device --------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    emit({"phase": "device", "name": torch.cuda.get_device_name(0), "nvidia_smi": smi,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "tf32": False})

    # -- 2. build ---------------------------------------------------------
    t0 = time.perf_counter()
    native.build(verbose=True)
    native.lib()
    build_s = time.perf_counter() - t0
    print(native.build_log(), file=sys.stderr)
    t0 = time.perf_counter()
    cpu = {n: build_likelihood(nt, n) for n in SHAPES_MAIN}
    model_s = time.perf_counter() - t0
    emit({"phase": "build", "nvcc_s": build_s, "models_s": model_s})

    # -- 3. kernels against their plain versions ---------------------------
    g = torch.Generator(device=dev).manual_seed(0)
    summary = {}

    def record(key, err, ms, plain_ms):
        s = summary.setdefault(key, {"max_abs_err": 0.0})
        s["max_abs_err"] = max(s["max_abs_err"], err)
        s["ms"], s["plain_ms"] = ms, plain_ms  # the last (largest) shape's times

    for n in SHAPES_MAIN:
        index = cpu[n][0].forward_model.inner.indexes[0]
        index_d = copy.deepcopy(index).to(dev)
        U, P = index.n_unique, index.n_packed
        n_large = int(index.large_bins.numel())
        max_bin = int(np.diff(index.offsets.numpy()).max())
        for B in (1, 4):
            shape = (U,) if B == 1 else (U, B)
            tab = torch.randn(shape, generator=g, device=dev)
            out = ce.expand_gather(tab, index_d)
            ref = ce.expand_gather_plain(tab, index_d)
            if not torch.equal(out, ref):
                fail(f"K1 differs from tab[idx] at {n}² B={B}")
            ms = cuda_ms(lambda: ce.expand_gather(tab, index_d))
            pms = cuda_ms(lambda: ce.expand_gather_plain(tab, index_d))
            cshape = (P,) if B == 1 else (P, B)
            cot = torch.randn(cshape, generator=g, device=dev)
            seg = ce.expand_segment_sum(cot, index_d)
            seg2 = ce.expand_segment_sum(cot, index_d)
            if not torch.equal(seg, seg2):
                fail(f"K2 is not deterministic at {n}² B={B}")
            ref64 = ce.expand_segment_sum_plain(cot.double().cpu(), index)
            k2_err = rel_max(seg.double().cpu(), ref64)
            if not k2_err <= TOL["k2"]:
                fail(f"K2 relative error {k2_err} > {TOL['k2']} at {n}² B={B}")
            k2_abs = float((seg.double().cpu() - ref64).abs().max())
            k2_ms = cuda_ms(lambda: ce.expand_segment_sum(cot, index_d))
            k2_pms = cuda_ms(lambda: ce.expand_segment_sum_plain(cot, index_d))
            emit({"phase": "kernels", "kernel": "K1+K2", "layout": f"{n}x{n}_exact", "B": B,
                  "P": P, "U": U, "large_bins": n_large, "max_bin": max_bin,
                  "k1_exact": True, "k1_ms": ms, "k1_plain_ms": pms,
                  "k2_rel_err": k2_err, "k2_ms": k2_ms, "k2_plain_ms": k2_pms})
            if B == 1:
                record("K1", 0.0, ms, pms)
                record("K2", k2_abs, k2_ms, k2_pms)

    for n in SHAPES_HARTLEY:
        x = torch.randn((n, n), generator=g, device=dev)
        G = cfft.hartley_rows(x)
        Gp = cfft.hartley_rows_plain(x)
        e3 = rel_max(G, Gp)
        H = cfft.hartley_cols(Gp, n)
        Hp = cfft.hartley_cols_plain(Gp, n)
        e4 = rel_max(H, Hp)
        full = cfft.hartley2d(x)
        e_full = rel_max(full, Hp)
        e_inv = rel_max(cfft.hartley2d(full) / x.numel(), x)
        for what, err in (("K3", e3), ("K4", e4), ("K3+K4", e_full), ("H(H(x))/N", e_inv)):
            if not err <= TOL["hartley"]:
                fail(f"{what} relative error {err} > {TOL['hartley']} at {n}²")
        ms3 = cuda_ms(lambda: cfft.hartley_rows(x), iters=10)
        pms3 = cuda_ms(lambda: cfft.hartley_rows_plain(x), iters=10)
        ms4 = cuda_ms(lambda: cfft.hartley_cols(Gp, n), iters=10)
        pms4 = cuda_ms(lambda: cfft.hartley_cols_plain(Gp, n), iters=10)
        emit({"phase": "kernels", "kernel": "K3+K4", "shape": [n, n],
              "k3_rel_err": e3, "k4_rel_err": e4, "hartley_rel_err": e_full,
              "inverse_rel_err": e_inv, "k3_ms": ms3, "k3_plain_ms": pms3,
              "k4_ms": ms4, "k4_plain_ms": pms4})
        if n in SHAPES_MAIN:
            record("K3", float((G - Gp).abs().max()), ms3, pms3)
            record("K4", float((H - Hp).abs().max()), ms4, pms4)
        del x, G, Gp, H, Hp, full
        torch.cuda.empty_cache()

    # -- 4. main path -----------------------------------------------------
    native.reset_launches()
    apply_ms = {}
    for n in SHAPES_MAIN:
        lh_cpu, pos_np, tan_np = cpu[n]
        torch.cuda.reset_peak_memory_stats()
        lh = copy.deepcopy(lh_cpu).to(dev, torch.float32)
        p = nt.position_from_numpy(lh.forward_model, pos_np, device=dev, dtype=torch.float32)
        t = nt.position_from_numpy(lh.forward_model, tan_np, device=dev, dtype=torch.float32)
        m = lh.metric(p, t)
        torch.cuda.synchronize()
        for k, v in m.items():
            if v.shape != t[k].shape or not bool(torch.isfinite(v).all()):
                fail(f"metric leaf {k} at {n}²: shape {tuple(v.shape)} or non-finite values")
        times = []
        for _ in range(10):
            s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            s.record()
            lh.metric(p, t)
            e.record()
            torch.cuda.synchronize()
            times.append(s.elapsed_time(e))
        apply_ms[n] = float(np.median(times))
        line = {"phase": "main_path", "shape": [n, n], "variant": "exact", "dtype": "float32",
                "metric_apply_ms_median": apply_ms[n], "metric_apply_ms_all": times,
                "peak_mem_bytes": torch.cuda.max_memory_allocated()}
        if n == SHAPES_MAIN[0]:
            p64 = nt.position_from_numpy(lh_cpu.forward_model, pos_np, dtype=torch.float64)
            t64 = nt.position_from_numpy(lh_cpu.forward_model, tan_np, dtype=torch.float64)
            ref = lh_cpu.metric(p64, t64)
            num = sum(float(((m[k].double().cpu() - ref[k]) ** 2).sum()) for k in ref)
            den = sum(float((ref[k] ** 2).sum()) for k in ref)
            rel_l2 = (num / den) ** 0.5
            line["rel_l2_vs_cpu_f64"] = rel_l2
            if not rel_l2 <= TOL["metric"]:
                fail(f"metric at {n}²: relative L2 {rel_l2} > {TOL['metric']} against CPU f64")
        emit(line)
        if n != SHAPES_MAIN[0]:
            del lh, p, t, m
            torch.cuda.empty_cache()
        else:
            lh_small, p_small, t_small = lh, p, t

    # -- 5. a few CG steps: (M + 1) x = b at 1280² -------------------------
    def mat(x):
        mx = lh_small.metric(p_small, x)
        return {k: mx[k] + x[k] for k in x}

    b = t_small
    b_norm = float(nt.norm(b))

    def residual(n_iter):
        x = nt.cg(mat, b, maxiter=n_iter, miniter=n_iter, absdelta=0.0).x
        r = mat(x)
        return float(nt.norm({k: r[k] - b[k] for k in b})) / b_norm

    # CG guarantees a falling energy (cg raises if it rises); the residual
    # norm of an ill-conditioned system first jumps and then falls, so it
    # is held against the residual after the first iteration
    first = residual(1)
    t0 = time.perf_counter()
    last = residual(CG_ITERS)
    torch.cuda.synchronize()
    cg_s = time.perf_counter() - t0
    emit({"phase": "cg", "shape": [SHAPES_MAIN[0]] * 2, "iterations": CG_ITERS,
          "residual_over_rhs_after_1": first, f"residual_over_rhs_after_{CG_ITERS}": last,
          "seconds": cg_s})
    if not last < first:
        fail(f"CG residual did not fall: {last} after {CG_ITERS} iterations, {first} after 1")

    counts = dict(native.launches)
    names = {"K1": "expand_gather", "K2": "expand_segment_sum",
             "K3": "hartley_rows", "K4": "hartley_cols"}
    missing = [k for k, v in names.items() if counts.get(v, 0) == 0]
    if missing:
        fail(f"kernels not launched on the main path: {missing} (counts {counts})")

    sources = {"K1": ("nifty_tpu_torch/csrc/expand.cu", "nifty_tpu/ops/pallas_expand.py:108"),
               "K2": ("nifty_tpu_torch/csrc/expand.cu", "nifty_tpu/ops/pallas_expand.py:161"),
               "K3": ("nifty_tpu_torch/csrc/hartley.cu", "nifty_tpu/ops/pallas_fft.py:169"),
               "K4": ("nifty_tpu_torch/csrc/hartley.cu", "nifty_tpu/ops/pallas_fft.py:246")}
    kernels = [
        {"name": f"{k} {names[k]}", "route": "cuda", "source": sources[k][0],
         "replaces": sources[k][1], "launches": counts[names[k]],
         "max_abs_err": summary[k]["max_abs_err"], "ms": summary[k]["ms"],
         "plain_ms": summary[k]["plain_ms"]}
        for k in names
    ]
    print(smi)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
