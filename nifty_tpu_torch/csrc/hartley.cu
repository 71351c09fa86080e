// K3 + K4: the unnormalised 2-D Hartley transform H = Re F - Im F of a real
// f32 (n0, n1) array, both axes multiples of 256.
//
// Replaces nifty_tpu/ops/pallas_fft.py:_p1 (K3, the row four-step DFT) and
// :_p2 (K4, the column four-step DFT with the Hartley fold fused in).  The TPU
// pair computed its DFTs as dense bf16x3 matmuls on the MXU; here each 1-D
// transform is a mixed-radix (2, 3, 4, 5, 7) in-place decimation-in-time FFT
// in shared memory, in f32 with twiddles built in double on the host.
//
// What bounds it on the card: an FFT does ~5 n log2 n flops on n complex
// values, far below the H100's flop/byte balance, so both passes are bound by
// device-memory bytes.  The design moves each byte once per pass:
//   K3 (rows): a block takes two real rows as one complex row z = a + i b
//     (halving the work of a real FFT), transforms it in shared memory and
//     splits the two half spectra A = (Z_k + conj Z_{n-k})/2 and
//     B = (Z_k - conj Z_{n-k})/2i; it writes the (n0, n1/2+1) half spectrum.
//   K4 (columns): a block loads a tile of tc adjacent half-spectrum columns
//     (tc complex values per row, so the loads stay in whole sectors where
//     the shared-memory budget allows tc > 1), transforms each column and
//     stores the Hartley value twice from the same DFT value, with the
//     hermitian fold fused into the store (as hartley_splitreal does):
//       H[i, c]           = Re C[i, c] - Im C[i, c]     for c <= n1/2
//       H[-i mod n0, n1-c] = Re C[i, c] + Im C[i, c]     for 1 <= c < n1/2.
// A row of 10240 complex values is 80 KB of shared memory, above the 48 KB
// default, so each launch raises the kernel's dynamic shared-memory limit
// and reports a refusal through the returned error code.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxStages = 32;

struct Plan {
  int n;                     // transform length
  int n_stages;              // number of radix stages
  int radix[kMaxStages];     // radix of each stage, smallest sub-DFT first
};

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// Shared-memory position of element i: one float2 of padding every 32 and
// every 1024 elements, so the power-of-two strides of the first stages and
// of the digit-reversed load do not all fall on one bank.
__host__ __device__ __forceinline__ int pad(int i) { return i + (i >> 5) + (i >> 10); }

__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}

__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}

// The R-point DFT out[q] = sum_r a[r] w^{r q}, w = exp(-2 pi i / R), in place.
// wR[j] = w^j for the odd radices; radix 2 and 4 use exact +-1, +-i.
template <int R>
__device__ __forceinline__ void small_dft(float2 (&a)[R], const float2 (&wR)[R]) {
  if constexpr (R == 2) {
    const float2 t = a[1];
    a[1] = csub(a[0], t);
    a[0] = cadd(a[0], t);
  } else if constexpr (R == 4) {
    const float2 t0 = cadd(a[0], a[2]), t1 = csub(a[0], a[2]);
    const float2 t2 = cadd(a[1], a[3]), t3 = csub(a[1], a[3]);
    a[0] = cadd(t0, t2);
    a[2] = csub(t0, t2);
    a[1] = make_float2(t1.x + t3.y, t1.y - t3.x);  // t1 - i t3
    a[3] = make_float2(t1.x - t3.y, t1.y + t3.x);  // t1 + i t3
  } else {
    float2 out[R];
#pragma unroll
    for (int q = 0; q < R; ++q) {
      float2 s = a[0];
#pragma unroll
      for (int r = 1; r < R; ++r) s = cadd(s, cmul(a[r], wR[(r * q) % R]));
      out[q] = s;
    }
#pragma unroll
    for (int q = 0; q < R; ++q) a[q] = out[q];
  }
}

// One radix-R stage over n_cols columns (column c at buf + c * col_stride):
// combines R sub-DFTs of length m, held at base + r m (shared-memory
// positions through pad), into one of length
// L = m R.  tw[j] = exp(-2 pi i j / n); the stage twiddle w_L^{r k} is
// tw[r k n / L] and the radix's own root w_R^j is tw[j n / R].
template <int R>
__device__ void fft_stage(float2* buf, int n_cols, int col_stride, int n,
                          int m, const float2* __restrict__ tw) {
  float2 wR[R];
#pragma unroll
  for (int j = 0; j < R; ++j) wR[j] = __ldg(tw + j * (n / R));
  const int L = m * R;
  const int tw_step = n / L;
  const int per_col = n / R;
  const int total = per_col * n_cols;
  for (int e = threadIdx.x; e < total; e += blockDim.x) {
    const int c = e / per_col;
    const int b = e - c * per_col;
    const int g = b / m;
    const int k = b - g * m;
    float2* col = buf + c * col_stride;
    const int base = g * L + k;
    float2 a[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float2 v = col[pad(base + r * m)];
      a[r] = r == 0 ? v : cmul(v, __ldg(tw + r * k * tw_step));
    }
    small_dft<R>(a, wR);
#pragma unroll
    for (int q = 0; q < R; ++q) col[pad(base + q * m)] = a[q];
  }
}

// In-place FFT of n_cols contiguous columns (column c at buf + c * col_stride),
// each loaded in the digit-reversed order of the plan.  All threads of the
// block take part; ends with the block synchronised.
__device__ void fft_columns(float2* buf, int n_cols, int col_stride,
                            const Plan& plan, const float2* __restrict__ tw) {
  const int n = plan.n;
  int m = 1;
  for (int t = 0; t < plan.n_stages; ++t) {
    const int R = plan.radix[t];
    switch (R) {
      case 2: fft_stage<2>(buf, n_cols, col_stride, n, m, tw); break;
      case 3: fft_stage<3>(buf, n_cols, col_stride, n, m, tw); break;
      case 4: fft_stage<4>(buf, n_cols, col_stride, n, m, tw); break;
      case 5: fft_stage<5>(buf, n_cols, col_stride, n, m, tw); break;
      case 7: fft_stage<7>(buf, n_cols, col_stride, n, m, tw); break;
    }
    __syncthreads();
    m *= R;
  }
}

// K3: rows (2p, 2p+1) -> half spectra (launched with up to 512 threads) G[2p, :], G[2p+1, :], h = n1/2 + 1
__global__ void __launch_bounds__(512) hartley_rows_kernel(const float* __restrict__ x,
                                    float2* __restrict__ G, int n1,
                                    const float2* __restrict__ tw,
                                    const int* __restrict__ iperm, Plan plan) {
  extern __shared__ float2 buf[];
  const long long ra = 2LL * blockIdx.x, rb = ra + 1;
  const float* xa = x + ra * n1;
  const float* xb = x + rb * n1;
  for (int j = threadIdx.x; j < n1; j += blockDim.x)
    buf[pad(__ldg(iperm + j))] = make_float2(xa[j], xb[j]);
  __syncthreads();
  fft_columns(buf, 1, n1, plan, tw);
  const int h = n1 / 2 + 1;
  float2* ga = G + ra * h;
  float2* gb = G + rb * h;
  for (int k = threadIdx.x; k < h; k += blockDim.x) {
    const float2 z = buf[pad(k)];
    const float2 zm = buf[pad(k == 0 ? 0 : n1 - k)];  // Z_{n-k}; conj taken below
    // A = (Z_k + conj Z_{n-k}) / 2,  B = (Z_k - conj Z_{n-k}) / 2i
    ga[k] = make_float2(0.5f * (z.x + zm.x), 0.5f * (z.y - zm.y));
    gb[k] = make_float2(0.5f * (z.y + zm.y), -0.5f * (z.x - zm.x));
  }
}

// K4: tc adjacent half-spectrum columns -> Hartley values, fold fused
// (launched with up to 1024 threads)
__global__ void __launch_bounds__(1024) hartley_cols_kernel(const float2* __restrict__ G,
                                    float* __restrict__ H, int n0, int n1,
                                    int tc, const float2* __restrict__ tw,
                                    const int* __restrict__ iperm, Plan plan) {
  extern __shared__ float2 buf[];
  const int h = n1 / 2 + 1;
  const int c0 = blockIdx.x * tc;
  const int n_cols = min(tc, h - c0);
  const int col_stride = pad(n0) + 1;  // one padded column
  const int total = n0 * tc;
  for (int e = threadIdx.x; e < total; e += blockDim.x) {
    const int i = e / tc;
    const int c = e - i * tc;
    if (c < n_cols)
      buf[c * col_stride + pad(__ldg(iperm + i))] = G[(long long)i * h + c0 + c];
  }
  __syncthreads();
  fft_columns(buf, n_cols, col_stride, plan, tw);
  for (int e = threadIdx.x; e < total; e += blockDim.x) {
    const int i = e / tc;
    const int c = e - i * tc;
    if (c >= n_cols) continue;
    const int col = c0 + c;
    const float2 v = buf[c * col_stride + pad(i)];
    H[(long long)i * n1 + col] = v.x - v.y;
    if (col >= 1 && col < n1 / 2) {
      const int im = i == 0 ? 0 : n0 - i;
      H[(long long)im * n1 + (n1 - col)] = v.x + v.y;
    }
  }
}

int make_plan(Plan* plan, int n, const int* radices, int n_stages) {
  if (n_stages < 0 || n_stages > kMaxStages) return (int)cudaErrorInvalidValue;
  plan->n = n;
  plan->n_stages = n_stages;
  long long prod = 1;
  for (int t = 0; t < n_stages; ++t) {
    const int r = radices[t];
    if (r != 2 && r != 3 && r != 4 && r != 5 && r != 7)
      return (int)cudaErrorInvalidValue;
    plan->radix[t] = r;
    prod *= r;
  }
  return prod == n ? 0 : (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int nt_hartley_rows(const void* x, void* G, int n0, int n1,
                               const void* tw, const void* iperm,
                               const int* radices, int n_stages, int threads,
                               void* stream) {
  Plan plan;
  int err = make_plan(&plan, n1, radices, n_stages);
  if (err) return err;
  if (n0 % 2 || threads > 512) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(pad(n1 - 1) + 1) * sizeof(float2);
  err = (int)cudaFuncSetAttribute(hartley_rows_kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)smem);
  if (err) return err;
  hartley_rows_kernel<<<n0 / 2, threads, smem, (cudaStream_t)stream>>>(
      (const float*)x, (float2*)G, n1, (const float2*)tw, (const int*)iperm,
      plan);
  return (int)cudaGetLastError();
}

extern "C" int nt_hartley_cols(const void* G, void* H, int n0, int n1, int tc,
                               const void* tw, const void* iperm,
                               const int* radices, int n_stages, int threads,
                               void* stream) {
  Plan plan;
  int err = make_plan(&plan, n0, radices, n_stages);
  if (err) return err;
  if (tc < 1 || threads > 1024) return (int)cudaErrorInvalidValue;
  const int h = n1 / 2 + 1;
  const size_t smem = (size_t)tc * (pad(n0) + 1) * sizeof(float2);
  err = (int)cudaFuncSetAttribute(hartley_cols_kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)smem);
  if (err) return err;
  hartley_cols_kernel<<<(h + tc - 1) / tc, threads, smem,
                        (cudaStream_t)stream>>>(
      (const float2*)G, (float*)H, n0, n1, tc, (const float2*)tw,
      (const int*)iperm, plan);
  return (int)cudaGetLastError();
}
