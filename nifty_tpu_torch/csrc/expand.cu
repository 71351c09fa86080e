// K1 and K2 of the exact-spectrum correlated field: the expansion of a
// per-unique-|k| table onto the packed harmonic core, and its adjoint.
//
// Replaces nifty_tpu/ops/pallas_expand.py:forward_fn (K1) and :transpose_fn
// (K2).  On the TPU both were Clos-routed lane-shuffle networks, because an
// XLA:TPU gather costs ~7 ns per index whatever the table size.  On Hopper a
// gather is an ordinary load: the table (at most a few MB at 4096^2) stays in
// the 50 MB L2, so both kernels are bound by device-memory bytes:
//   K1: 4 B of index read + 4*B B of output written per packed entry;
//   K2: 4 B of permutation + 4*B B of cotangent read per packed entry.
// K1 reads the index array coalesced, one thread per output element.  K2
// reduces each mode bin over a CSR permutation that the host builds once per
// layout (a stable argsort of the index and the bin offsets): a thread per
// small bin, a warp per large bin, each in a fixed order and without global
// atomics, so the sum is deterministic and CG runs repeat exactly.

#include <cuda_runtime.h>

namespace {

__global__ void gather_kernel(const float* __restrict__ tab,
                              const int* __restrict__ idx,
                              float* __restrict__ out, long long n_out, int B) {
  long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  long long stride = (long long)gridDim.x * blockDim.x;
  for (; e < n_out; e += stride) {
    long long p = e / B;
    int b = (int)(e - p * B);
    out[e] = __ldg(tab + (long long)__ldg(idx + p) * B + b);
  }
}

// one thread per (small bin, column): the members are summed in CSR order
__global__ void segsum_small_kernel(const float* __restrict__ cot,
                                    const int* __restrict__ perm,
                                    const int* __restrict__ offsets,
                                    const int* __restrict__ bins, int n_bins,
                                    float* __restrict__ out, int B) {
  long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  long long n = (long long)n_bins * B;
  long long stride = (long long)gridDim.x * blockDim.x;
  for (; e < n; e += stride) {
    int s = (int)(e / B);
    int b = (int)(e - (long long)s * B);
    int u = __ldg(bins + s);
    int lo = __ldg(offsets + u), hi = __ldg(offsets + u + 1);
    float acc = 0.f;
    for (int k = lo; k < hi; ++k)
      acc += __ldg(cot + (long long)__ldg(perm + k) * B + b);
    out[(long long)u * B + b] = acc;
  }
}

// one warp per (large bin, column): lane l sums members l, l+32, ... in
// order, then a fixed shuffle tree joins the 32 partial sums
__global__ void segsum_large_kernel(const float* __restrict__ cot,
                                    const int* __restrict__ perm,
                                    const int* __restrict__ offsets,
                                    const int* __restrict__ bins, int n_bins,
                                    float* __restrict__ out, int B) {
  const int lane = threadIdx.x & 31;
  long long w = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  long long n = (long long)n_bins * B;
  long long wstride = ((long long)gridDim.x * blockDim.x) >> 5;
  for (; w < n; w += wstride) {
    int s = (int)(w / B);
    int b = (int)(w - (long long)s * B);
    int u = __ldg(bins + s);
    int lo = __ldg(offsets + u), hi = __ldg(offsets + u + 1);
    float acc = 0.f;
    for (int k = lo + lane; k < hi; k += 32)
      acc += __ldg(cot + (long long)__ldg(perm + k) * B + b);
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_down_sync(0xffffffffu, acc, off);
    if (lane == 0) out[(long long)u * B + b] = acc;
  }
}

int grid_for(long long n, int threads) {
  long long g = (n + threads - 1) / threads;
  if (g < 1) g = 1;
  if (g > 65535LL * 16) g = 65535LL * 16;
  return (int)g;
}

}  // namespace

extern "C" int nt_expand_gather(const void* tab, const void* idx, void* out,
                                long long P, int B, void* stream) {
  const int threads = 256;
  long long n = P * (long long)B;
  if (n > 0)
    gather_kernel<<<grid_for(n, threads), threads, 0, (cudaStream_t)stream>>>(
        (const float*)tab, (const int*)idx, (float*)out, n, B);
  return (int)cudaGetLastError();
}

extern "C" int nt_expand_segment_sum(const void* cot, const void* perm,
                                     const void* offsets, const void* small_bins,
                                     int n_small, const void* large_bins,
                                     int n_large, void* out, int B,
                                     void* stream) {
  const int threads = 256;
  cudaStream_t s = (cudaStream_t)stream;
  if (n_small > 0) {
    segsum_small_kernel<<<grid_for((long long)n_small * B, threads), threads, 0,
                          s>>>((const float*)cot, (const int*)perm,
                               (const int*)offsets, (const int*)small_bins,
                               n_small, (float*)out, B);
    int err = (int)cudaGetLastError();
    if (err) return err;
  }
  if (n_large > 0) {
    segsum_large_kernel<<<grid_for((long long)n_large * B * 32, threads),
                          threads, 0, s>>>(
        (const float*)cot, (const int*)perm, (const int*)offsets,
        (const int*)large_bins, n_large, (float*)out, B);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* nt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
