#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port's main path once on one NVIDIA GPU.

Usage: ``python3 chip_smoke.py`` from the root of a checkout, on a machine
with one CUDA card, ``nvcc`` and PyTorch built for CUDA.  It imports no
JAX.  Phases, each printing one JSON line to stdout:

1. device: requires CUDA; the card's name and power limit (nvidia-smi);
2. build: compiles ``nifty_tpu_torch/csrc/*.cu`` with nvcc (set-up time)
   and builds the 1280²- and 4096²-exact models on the card (f32) through
   the entry points, and the 1280² one on the CPU in f64 as the reference;
3. kernels: each hand-written kernel against its plain PyTorch version on
   the card, at the main path's shapes: K1 (table -> full grid) and K2
   (full grid -> table) at 1280² and 4096², B = 1 and 4; K3/K4 at 1024²
   (the VI phase), 1280², 4096² and 10240².  Times are device times: 20
   calls captured in one CUDA graph, replayed between CUDA events, so no
   host dispatch is in them.  Beside each: ``plain_ms`` (for K1/K2 the composition of layout
   ops the kernel replaces), ``bound_ms``, the least time the card could
   take (the larger of the bytes moved, each input read once and each
   output written once, over 3.35 TB/s and the flops over 67 TFLOP/s
   f32), and ``library_ms``, the one PyTorch call that computes the same
   function (``index_select`` / ``index_add_`` over the full-grid int32
   index, made once for them; ``rfft``; none for K4);
4. main path: ``Poissonian(data).amend(ChainModel(torch.exp, cf))`` with
   the exact-spectrum correlated field at 1280² and 4096², f32 on the
   card: the Fisher-metric apply, its median time, and at 1280² its
   agreement with the same model in f64 on the CPU;
5. cg: 20 conjugate-gradient iterations on (M + 1) x = b at 1280², the
   inner solve of an MGVI sample draw; the residual must fall below its
   value after the first iteration;
6. knot: the 64-knot model of ``bench.py:78-88`` at 1280², 4096² and
   10240², f32 on the card: the metric apply's median over 10 (CUDA
   events), peak memory, and at 1280² its agreement with the same model in
   f64 on the CPU; K3/K4 must launch and K1/K2 must not (no table);
7. vi: one MGVI and one geoVI iteration (``OptimizeVI.update``) at 1024²
   knot64 with ``bench_extra.py``'s settings (2 mirrored sample pairs,
   the draw's static CG 20 iterations, geoVI Newton-CG 2 steps of CG 5,
   the KL one Newton step of CG 10), seconds per iteration the median of
   3 after one warm-up; every sample and the new position finite and on
   the card, the sample-averaged KL after the Newton step not above its
   value before, K3/K4 launched.

The launch counters are set to 0 just before each of phases 4-7 and read
just after it: K1-K4 must launch in phases 4 and 5, K3/K4 (and not K1/K2)
in 6 and 7.  Then it prints the card line, the kernel summary (launches per
phase) and, last, ``{"ok": true, "device": ...}``.  Any failure raises, so
the exit code is not 0 and no result line is printed.

Tolerances (and why): K1 exact (a gather computes nothing); K2 relative
1e-6 against its float64 plain version (f32 sums over one bin in a fixed
order), and the same bits on two calls; Hartley max|Δ|/max|ref| <= 1e-5 (f32 FFT rounding); metric
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
SHAPES_KNOT = (1280, 4096, 10240)
KNOTS = 64
VI_SHAPE = 1024
SHAPES_HARTLEY = (VI_SHAPE, 1280, 4096, 10240)  # ascending: the summary keeps 4096²'s times
CG_ITERS = 20
NAMES = {"K1": "expand_to_grid", "K2": "collapse_from_grid",
         "K3": "hartley_rows", "K4": "hartley_cols"}
TOL = {"k2": 1e-6, "hartley": 1e-5, "metric": 1e-4}  # K1 must be exact


def emit(obj):
    print(json.dumps(obj), flush=True)


def fail(msg):
    raise RuntimeError(msg)


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
    from nifty_tpu_torch.bench.timing import bound, device_ms, fft_flops
    from nifty_tpu_torch.bench.workload import build_likelihood, build_vi_likelihood, vi_settings
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
    card = {n: build_likelihood(n, dev, torch.float32) for n in SHAPES_MAIN}
    ref64 = build_likelihood(SHAPES_MAIN[0], "cpu", torch.float64)
    model_s = time.perf_counter() - t0
    emit({"phase": "build", "nvcc_s": build_s, "models_s": model_s})

    # -- 3. kernels against their plain versions ---------------------------
    g = torch.Generator(device=dev).manual_seed(0)
    summary = {}

    def record(key, err, times):
        s = summary.setdefault(key, {"max_abs_err": 0.0})
        s["max_abs_err"] = max(s["max_abs_err"], err)
        s.update(times)  # the last (largest) main-path shape's times

    def timing(ms, plain_ms, n_bytes, flops=0.0, library_ms=None):
        b_ms, b_by = bound(n_bytes, flops)
        return {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": library_ms}

    for n in SHAPES_MAIN:
        index_d = card[n][0].forward_model.inner.indexes[0]
        index = copy.deepcopy(index_d).to("cpu")
        full = (n, n)
        U, P, N = index.n_unique, index.n_packed, n * n
        # the yardsticks' full-grid int32 index, made once for them only
        full_idx = ce.expand_to_grid_plain(
            torch.arange(U, dtype=torch.float64), index, full).reshape(-1).to(dev, torch.int32)
        for B in (1, 4):
            batch = () if B == 1 else (B,)
            tab = torch.randn((U,) + batch, generator=g, device=dev)
            out = ce.expand_to_grid(tab, index_d, full)
            if not torch.equal(out, ce.expand_to_grid_plain(tab, index_d, full)):
                fail(f"K1 differs from its plain version at {n}² B={B}")
            if not torch.equal(out.reshape((N,) + batch), tab.index_select(0, full_idx)):
                fail(f"K1 differs from tab[full_idx] at {n}² B={B}")
            n_bytes = 4 * U * B + 4 * P + 4 * N * B  # table, packed index, grid
            k1 = timing(device_ms(lambda: ce.expand_to_grid(tab, index_d, full)),
                        device_ms(lambda: ce.expand_to_grid_plain(tab, index_d, full)),
                        n_bytes,
                        library_ms=device_ms(lambda: tab.index_select(0, full_idx)))
            cot = torch.randn(full + batch, generator=g, device=dev)
            seg = ce.collapse_from_grid(cot, index_d, full)
            if not torch.equal(seg, ce.collapse_from_grid(cot, index_d, full)):
                fail(f"K2 is not deterministic at {n}² B={B}")
            seg_ref = ce.collapse_from_grid_plain(cot.double().cpu(), index, full)
            k2_err = rel_max(seg.double().cpu(), seg_ref)
            if not k2_err <= TOL["k2"]:
                fail(f"K2 relative error {k2_err} > {TOL['k2']} at {n}² B={B}")
            k2_abs = float((seg.double().cpu() - seg_ref).abs().max())
            cot_flat = cot.reshape((N,) + batch)
            k2 = timing(device_ms(lambda: ce.collapse_from_grid(cot, index_d, full)),
                        device_ms(lambda: ce.collapse_from_grid_plain(cot, index_d, full)),
                        n_bytes,
                        library_ms=device_ms(lambda: cot.new_zeros((U,) + batch).index_add_(
                            0, full_idx, cot_flat)))
            emit({"phase": "kernels", "kernel": "K1+K2", "layout": f"{n}x{n}_exact",
                  "kind": index.layout.kind, "B": B, "P": P, "U": U, "N": N,
                  "large_bins": int(index.large_bins.numel()),
                  "k1_exact": True, **{f"k1_{k}": v for k, v in k1.items()},
                  "k2_rel_err": k2_err, **{f"k2_{k}": v for k, v in k2.items()}})
            if B == 1:
                record("K1", 0.0, k1)
                record("K2", k2_abs, k2)
            del out, cot, cot_flat, seg
        del full_idx
        torch.cuda.empty_cache()

    for n in SHAPES_HARTLEY:
        x = torch.randn((n, n), generator=g, device=dev)
        G = cfft.hartley_rows(x)
        Gp = cfft.hartley_rows_plain(x)
        e3 = rel_max(G, Gp)
        Gp_pad = cfft.padded_half_spectrum(Gp)
        H = cfft.hartley_cols(Gp_pad, n)
        Hp = cfft.hartley_cols_plain(Gp, n)
        e4 = rel_max(H, Hp)
        full = cfft.hartley2d(x)
        e_full = rel_max(full, Hp)
        e_inv = rel_max(cfft.hartley2d(full) / x.numel(), x)
        for what, err in (("K3", e3), ("K4", e4), ("K3+K4", e_full), ("H(H(x))/N", e_inv)):
            if not err <= TOL["hartley"]:
                fail(f"{what} relative error {err} > {TOL['hartley']} at {n}²")
        h = n // 2 + 1
        io_bytes = 4 * n * n + 8 * n * h  # one real array and one half spectrum
        rfft_ms = device_ms(lambda: cfft.hartley_rows_plain(x))  # plain K3 is rfft itself
        k3 = timing(device_ms(lambda: cfft.hartley_rows(x)), rfft_ms,
                    io_bytes, fft_flops(n, n // 2), library_ms=rfft_ms)
        k4 = timing(device_ms(lambda: cfft.hartley_cols(Gp_pad, n)),
                    device_ms(lambda: cfft.hartley_cols_plain(Gp, n)),
                    io_bytes, fft_flops(n, h))
        emit({"phase": "kernels", "kernel": "K3+K4", "shape": [n, n],
              "k3_rel_err": e3, "k4_rel_err": e4, "hartley_rel_err": e_full,
              "inverse_rel_err": e_inv, **{f"k3_{k}": v for k, v in k3.items()},
              **{f"k4_{k}": v for k, v in k4.items()}})
        if n in SHAPES_MAIN or n == VI_SHAPE:
            record("K3", float((G - Gp).abs().max()), k3)
            record("K4", float((H - Hp).abs().max()), k4)
        del x, G, Gp, Gp_pad, H, Hp, full
        torch.cuda.empty_cache()

    # -- 4. main path -----------------------------------------------------
    def rel_l2(got, ref):
        num = sum(float(((got[k].double().cpu() - ref[k]) ** 2).sum()) for k in ref)
        return (num / sum(float((ref[k] ** 2).sum()) for k in ref)) ** 0.5

    def metric_phase(phase, variant, n, lh, pos_np, tan_np, lh64=None):
        """Apply the metric once (checked) and 10 times (timed) and emit the
        line; return the position and tangent on the card."""
        torch.cuda.reset_peak_memory_stats()
        p = nt.position_from_numpy(lh.forward_model, pos_np)  # the model's device and dtype
        t = nt.position_from_numpy(lh.forward_model, tan_np)
        m = lh.metric(p, t)
        torch.cuda.synchronize()
        for k, v in m.items():
            if v.shape != t[k].shape or v.device != dev or not bool(torch.isfinite(v).all()):
                fail(f"{variant} metric leaf {k} at {n}²: shape {tuple(v.shape)}, {v.device} or non-finite")
        times = []
        for _ in range(10):
            s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            s.record()
            lh.metric(p, t)
            e.record()
            torch.cuda.synchronize()
            times.append(s.elapsed_time(e))
        line = {"phase": phase, "shape": [n, n], "variant": variant, "dtype": "float32",
                "metric_apply_ms_median": float(np.median(times)), "metric_apply_ms_all": times,
                "peak_mem_bytes": torch.cuda.max_memory_allocated()}
        if lh64 is not None:
            ref = lh64.metric(nt.position_from_numpy(lh64.forward_model, pos_np),
                              nt.position_from_numpy(lh64.forward_model, tan_np))
            line["rel_l2_vs_cpu_f64"] = err = rel_l2(m, ref)
            if not err <= TOL["metric"]:
                fail(f"{variant} metric at {n}²: relative L2 {err} > {TOL['metric']} against CPU f64")
        emit(line)
        return p, t

    launches = {}  # phase -> {kernel wrapper: launches}

    def read_launches(phase, need, refuse=()):
        launches[phase] = counts = dict(native.launches)
        missing = [k for k in need if counts.get(NAMES[k], 0) == 0]
        stray = [k for k in refuse if counts.get(NAMES[k], 0)]
        if missing or stray:
            fail(f"{phase}: kernels not launched {missing}, launched but off the path {stray} "
                 f"(counts {counts})")

    native.reset_launches()
    for n in SHAPES_MAIN:
        lh, pos_np, tan_np = card.pop(n)
        ref = ref64[0] if n == SHAPES_MAIN[0] else None
        p, t = metric_phase("main_path", "exact", n, lh, pos_np, tan_np, ref)
        if n == SHAPES_MAIN[0]:
            lh_small, p_small, t_small = lh, p, t
        del lh, p, t
        torch.cuda.empty_cache()
    read_launches("main_path", NAMES)

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
    native.reset_launches()
    first = residual(1)
    t0 = time.perf_counter()
    last = residual(CG_ITERS)
    torch.cuda.synchronize()
    cg_s = time.perf_counter() - t0
    read_launches("cg", NAMES)
    emit({"phase": "cg", "shape": [SHAPES_MAIN[0]] * 2, "iterations": CG_ITERS,
          "residual_over_rhs_after_1": first, f"residual_over_rhs_after_{CG_ITERS}": last,
          "seconds": cg_s})
    if not last < first:
        fail(f"CG residual did not fall: {last} after {CG_ITERS} iterations, {first} after 1")
    del lh_small, p_small, t_small, b
    torch.cuda.empty_cache()

    # -- 6. the 64-knot metric apply ------------------------------------------
    knot64 = build_likelihood(SHAPES_KNOT[0], "cpu", torch.float64, n_mode_knots=KNOTS)[0]
    native.reset_launches()
    for n in SHAPES_KNOT:
        t0 = time.perf_counter()
        lh, pos_np, tan_np = build_likelihood(n, dev, torch.float32, n_mode_knots=KNOTS)
        emit({"phase": "knot_build", "shape": [n, n], "seconds": time.perf_counter() - t0})
        ref = knot64 if n == SHAPES_KNOT[0] else None
        metric_phase("knot", f"knot{KNOTS}", n, lh, pos_np, tan_np, ref)
        del lh, pos_np, tan_np
        torch.cuda.empty_cache()
    read_launches("knot", ("K3", "K4"), refuse=("K1", "K2"))
    del knot64

    # -- 7. one MGVI and one geoVI iteration at 1024² knot64 -------------------
    lh_vi, start_np = build_vi_likelihood(VI_SHAPE, dev, torch.float32, KNOTS)
    start = nt.Samples(pos=nt.position_from_numpy(lh_vi.forward_model, start_np))
    seed = int(np.random.default_rng(3).integers(2**62))
    opt_vi = nt.OptimizeVI(lh_vi, 1)
    native.reset_launches()
    for mode in ("linear_resample", "nonlinear_resample"):
        state = opt_vi.init_state(torch.Generator(device=dev).manual_seed(seed),
                                  sample_mode=mode, **vi_settings())
        seconds = []
        for _ in range(4):  # one warm-up, then 3 timed
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            samples, new_state = opt_vi.update(start, state)
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t0)
        trees = [("position", samples.pos)] + [(f"sample {i}", s) for i, s in enumerate(samples)]
        for what, tree in trees:
            for k, v in tree.items():
                if v.device != dev or not bool(torch.isfinite(v).all()):
                    fail(f"vi {mode}: {what} leaf {k} on {v.device} or non-finite")
        kl_before = float(opt_vi.kl_value_and_grad(start.pos, primals_samples=samples)[0])
        kl_after = float(new_state.minimization_state.fun)
        emit({"phase": "vi", "mode": mode, "shape": [VI_SHAPE] * 2, "knots": KNOTS,
              "samples": len(samples), "s_per_iteration_median": float(np.median(seconds[1:])),
              "s_per_iteration_all": seconds, "kl_before": kl_before, "kl_after": kl_after,
              "kl_status": int(new_state.minimization_state.status),
              "sample_state": str(new_state.sample_state)[:200],
              "peak_mem_bytes": torch.cuda.max_memory_allocated()})
        if not kl_after <= kl_before:
            fail(f"vi {mode}: the KL rose over the Newton step ({kl_before} -> {kl_after})")
    read_launches("vi", ("K3", "K4"), refuse=("K1", "K2"))

    sources = {"K1": ("nifty_tpu_torch/csrc/expand.cu", "nifty_tpu/ops/pallas_expand.py:108"),
               "K2": ("nifty_tpu_torch/csrc/expand.cu", "nifty_tpu/ops/pallas_expand.py:161"),
               "K3": ("nifty_tpu_torch/csrc/hartley.cu", "nifty_tpu/ops/pallas_fft.py:169"),
               "K4": ("nifty_tpu_torch/csrc/hartley.cu", "nifty_tpu/ops/pallas_fft.py:246")}
    kernels = [
        {"name": f"{k} {NAMES[k]}", "route": "cuda", "source": sources[k][0],
         "replaces": sources[k][1],
         "launches": sum(c.get(NAMES[k], 0) for c in launches.values()),
         "launches_by_phase": {ph: c.get(NAMES[k], 0) for ph, c in launches.items()},
         **summary[k]}
        for k in NAMES
    ]
    print(smi)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
