#!/usr/bin/env python3
"""Throughput and fragment layouts of the float64 ``mma.sync`` shapes on the card.

Usage: ``python3 nifty_tpu_torch/bench/dmma_bench.py`` on a machine with a
CUDA card and ``nvcc``.  It builds a small standalone program (the CUDA
source below, for ``sm_90a``) in a temporary directory and runs it.  For
each shape (m8n8k4, m16n8k4, m16n8k8, m16n8k16) it prints one JSON line:
``max_abs_err`` of one product computed through the fragment layouts that
``csrc/legendre.cu`` assumes, against a host loop (exact for the small
integers used), and ``tflops``, float64 FLOP/s of warps issuing 8
independent accumulator chains (132 x 8 blocks of 4 warps, CUDA events).
It chose the shape of the tensor-core K5/K6 kernels.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile

SOURCE = r"""
#include <cstdio>
#include <cuda_runtime.h>

// fragments (g = lane / 4, t = lane % 4):
//   m8n8k4:   A a0 (g, t); B b0 (t, g); D d0, d1 (g, 2t + i)
//   m16n8kK:  A a[2j + h] (g + 8 h, t + 4 j); B b[j] (t + 4 j, g);
//             D d[2 h + i] (g + 8 h, 2t + i)
template <int S> struct Shape;
template <> struct Shape<0> { static constexpr int M = 8, N = 8, K = 4, NA = 1, NB = 1, ND = 2; };
template <> struct Shape<1> { static constexpr int M = 16, N = 8, K = 4, NA = 2, NB = 1, ND = 4; };
template <> struct Shape<2> { static constexpr int M = 16, N = 8, K = 8, NA = 4, NB = 2, ND = 4; };
template <> struct Shape<3> { static constexpr int M = 16, N = 8, K = 16, NA = 8, NB = 4, ND = 4; };

template <int S> __device__ __forceinline__ void mma(double* d, const double* a, const double* b);
template <> __device__ __forceinline__ void mma<0>(double* d, const double* a, const double* b) {
  asm volatile("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0,%1}, {%2}, {%3}, {%0,%1};\n"
               : "+d"(d[0]), "+d"(d[1]) : "d"(a[0]), "d"(b[0]));
}
template <> __device__ __forceinline__ void mma<1>(double* d, const double* a, const double* b) {
  asm volatile("mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};\n"
               : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3]) : "d"(a[0]), "d"(a[1]), "d"(b[0]));
}
template <> __device__ __forceinline__ void mma<2>(double* d, const double* a, const double* b) {
  asm volatile("mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
               : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
               : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]));
}
template <> __device__ __forceinline__ void mma<3>(double* d, const double* a, const double* b) {
  asm volatile("mma.sync.aligned.m16n8k16.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, {%4,%5,%6,%7,%8,%9,%10,%11}, {%12,%13,%14,%15}, {%0,%1,%2,%3};\n"
               : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
               : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(a[4]), "d"(a[5]), "d"(a[6]), "d"(a[7]),
                 "d"(b[0]), "d"(b[1]), "d"(b[2]), "d"(b[3]));
}

template <int S> __device__ void a_rc(int lane, int e, int& r, int& c) {
  const int g = lane >> 2, t = lane & 3;
  if (S == 0) { r = g; c = t; return; }
  r = g + 8 * (e & 1); c = t + 4 * (e >> 1);
}
template <int S> __device__ void b_rc(int lane, int e, int& r, int& c) {
  r = (lane & 3) + 4 * e; c = lane >> 2;
}
template <int S> __device__ void d_rc(int lane, int e, int& r, int& c) {
  r = (lane >> 2) + 8 * (e >> 1); c = 2 * (lane & 3) + (e & 1);
}

template <int S> __global__ void layout_kernel(const double* A, const double* B, double* D) {
  using Sh = Shape<S>;
  const int lane = threadIdx.x;
  double a[Sh::NA], b[Sh::NB], d[Sh::ND];
  for (int e = 0; e < Sh::NA; ++e) { int r, c; a_rc<S>(lane, e, r, c); a[e] = A[r * Sh::K + c]; }
  for (int e = 0; e < Sh::NB; ++e) { int r, c; b_rc<S>(lane, e, r, c); b[e] = B[r * Sh::N + c]; }
  for (int e = 0; e < Sh::ND; ++e) d[e] = 0.0;
  mma<S>(d, a, b);
  for (int e = 0; e < Sh::ND; ++e) { int r, c; d_rc<S>(lane, e, r, c); D[r * Sh::N + c] = d[e]; }
}

constexpr int kChains = 8, kIters = 4096;
template <int S> __global__ void throughput_kernel(double* out) {
  using Sh = Shape<S>;
  double a[Sh::NA], b[Sh::NB], d[kChains][Sh::ND];
  for (int e = 0; e < Sh::NA; ++e) a[e] = 1e-3 * (threadIdx.x + e);
  for (int e = 0; e < Sh::NB; ++e) b[e] = 1e-3 * (threadIdx.x - e);
  for (int c = 0; c < kChains; ++c) for (int e = 0; e < Sh::ND; ++e) d[c][e] = 0.0;
  for (int i = 0; i < kIters; ++i) {
#pragma unroll
    for (int c = 0; c < kChains; ++c) mma<S>(d[c], a, b);
  }
  double s = 0.0;
  for (int c = 0; c < kChains; ++c) for (int e = 0; e < Sh::ND; ++e) s += d[c][e];
  if (s == 12345.0) out[threadIdx.x] = s;
}

template <int S> void run(const char* name) {
  using Sh = Shape<S>;
  double hA[16 * 16], hB[16 * 8], hD[16 * 8], ref[16 * 8];
  for (int i = 0; i < Sh::M * Sh::K; ++i) hA[i] = (double)((i * 7) % 11 - 5);
  for (int i = 0; i < Sh::K * Sh::N; ++i) hB[i] = (double)((i * 5) % 13 - 6);
  for (int r = 0; r < Sh::M; ++r) for (int c = 0; c < Sh::N; ++c) {
    double s = 0.0; for (int k = 0; k < Sh::K; ++k) s += hA[r * Sh::K + k] * hB[k * Sh::N + c];
    ref[r * Sh::N + c] = s;
  }
  double *A, *B, *D, *out;
  cudaMalloc(&A, sizeof hA); cudaMalloc(&B, sizeof hB); cudaMalloc(&D, sizeof hD); cudaMalloc(&out, 4096);
  cudaMemcpy(A, hA, sizeof hA, cudaMemcpyHostToDevice);
  cudaMemcpy(B, hB, sizeof hB, cudaMemcpyHostToDevice);
  layout_kernel<S><<<1, 32>>>(A, B, D);
  cudaMemcpy(hD, D, sizeof hD, cudaMemcpyDeviceToHost);
  double err = 0.0;
  for (int i = 0; i < Sh::M * Sh::N; ++i) err = fmax(err, fabs(hD[i] - ref[i]));
  const int blocks = 132 * 8, threads = 128;
  throughput_kernel<S><<<blocks, threads>>>(out);
  cudaEvent_t e0, e1; cudaEventCreate(&e0); cudaEventCreate(&e1);
  cudaEventRecord(e0);
  throughput_kernel<S><<<blocks, threads>>>(out);
  cudaEventRecord(e1); cudaEventSynchronize(e1);
  float ms = 0.f; cudaEventElapsedTime(&ms, e0, e1);
  const double flops = 2.0 * Sh::M * Sh::N * Sh::K * kChains * (double)kIters * blocks * (threads / 32);
  printf("{\"shape\": \"%s\", \"max_abs_err\": %g, \"ms\": %g, \"tflops\": %g, \"error\": \"%s\"}\n",
         name, err, ms, flops / ms / 1e9, cudaGetErrorString(cudaGetLastError()));
  cudaFree(A); cudaFree(B); cudaFree(D); cudaFree(out);
}

int main() {
  run<0>("m8n8k4"); run<1>("m16n8k4"); run<2>("m16n8k8"); run<3>("m16n8k16");
  return 0;
}
"""


def main() -> int:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        print("dmma_bench: no CUDA toolkit", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    with tempfile.TemporaryDirectory() as tmp:
        src, exe = os.path.join(tmp, "dmma.cu"), os.path.join(tmp, "dmma")
        with open(src, "w") as f:
            f.write(SOURCE)
        subprocess.run([os.path.join(CUDA_HOME, "bin", "nvcc"), "-gencode",
                        "arch=compute_90a,code=sm_90a", "-O3", "-o", exe, src], check=True)
        res = subprocess.run([exe], capture_output=True, text=True, check=True, timeout=120)
    for line in res.stdout.splitlines():
        print(json.dumps({**json.loads(line), "card": smi}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
