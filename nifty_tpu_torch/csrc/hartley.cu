// K3 + K4: the unnormalised 2-D Hartley transform H = Re F - Im F of a real
// f32 (n0, n1) array, both axes multiples of 256, 7-smooth, <= 24576.
//
// Replaces nifty_tpu/ops/pallas_fft.py:_p1 (K3, the row four-step DFT) and
// :_p2 (K4, the column four-step DFT with the Hartley fold fused in).  The
// TPU pair computed its DFTs as dense bf16x3 matmuls on the MXU; here each
// 1-D transform is an in-place mixed-radix FFT in f32 whose butterflies run
// in registers.
//
// What bounds it on the card: device-memory bytes.  Each pass reads and
// writes the array once: 134.3 MB per pass at 4096^2 (f32 in, complex64 half
// spectrum out, and back), 40 us at 3.35 TB/s.  An FFT does ~5 n log2 n
// flops, ~0.5 GFLOP per pass at 4096^2 (~8 us at 67 TFLOP/s f32), so tensor
// cores buy nothing and the design is for bytes and latency:
//
// 1. Register passes.  A pass of radix R (16, 8, 4, 2, 3, 5, 7; 16 and 8
//    are formed from 4*4 and 4*2 in registers) gives each thread whole
//    R-point butterflies of a decimation-in-frequency FFT: it reads R
//    elements from shared memory, transforms them and applies the twiddles
//    in registers, and writes them back to the same places.  A butterfly
//    reads and writes only its own elements, so a thread runs its
//    butterflies one after another and a pass ends in one barrier.  4096 =
//    16*16*16 is 3 passes with 2 exchanges (one shared-memory pass per
//    radix-4 stage would be 6, plus a digit-reversed scatter).  The output
//    lies in digit-reversed order; the stores read it through a host-built
//    table (cuda_fft.output_order).
//    The schedule is made on the host (cuda_fft.fft_plan): per pass its
//    radix, its stride m, the magic multiplier with j / m = umulhi(j, M) and
//    its twiddle stride, so no thread divides at run time; the radix is a
//    template parameter.  Shared-memory positions carry one element of
//    padding every 16 and every 256, so the stride-R accesses of the last
//    pass (m = 1) and the digit-reversed reads of the output fall on
//    distinct banks.
// 2. Twiddles.  w^m = hi[m >> 7] * lo[m & 127]: two tables of 128 and n/128
//    entries, built in double on the host, copied into shared memory at the
//    start of a block (<= 2.5 KB); no global reads per butterfly.  A radix-16
//    butterfly looks up w^k, w^2k, w^3k and w^4k, w^8k, w^12k and forms the
//    other nine as products.
// 3. K3 rows.  A block takes a pair of real rows as one complex row
//    z = a + i b, read as 16-byte vectors.  After the last pass the half
//    spectra A = (Z_k + conj Z_{n-k})/2 and B = (Z_k - conj Z_{n-k})/2i are
//    stored as 16-byte vectors into G, whose row pitch (n1/2 + 8 complex)
//    starts every row on 64 bytes; the 7 padding entries are written as
//    zeros.  (Several pairs per block, to keep blocks of short rows busy,
//    were slower at 1280, 4096 and 10240 in a sweep on the card.)
// 4. K4 columns.  The hermitian fold is fused into the store:
//       H[i, c]            = Re C[i, c] - Im C[i, c]     for c <= n1/2
//       H[-i mod n0, n1-c] = Re C[i, c] + Im C[i, c]     for 1 <= c < n1/2.
//    A column pass reads and writes a few bytes per row of a strided array,
//    and on the card its time went with the number of row pieces, not the
//    bytes: the widest tile of columns wins.  Up to n0 = 11776 a cluster of
//    2 or 4 blocks on as many SMs takes 8 columns, each block a part of the
//    rows (hartley_cols_cluster_kernel): 64-byte cp.async row pieces in,
//    two aligned 32-byte runs out per row.  The mirror of an aligned run is
//    never aligned (c and n1-c sum to n1), so the cluster also transforms
//    the extra column c0+8: columns c0+1 .. c0+8 give the aligned mirror
//    run H[-i, n1-c0-8 .. n1-c0-1].  Longer columns fit 2 or 1 per block
//    (hartley_cols_kernel), with scalar mirror stores.
// 5. Batches (the samples of a VI iteration, mapped by torch.func.vmap):
//    K3's rows are independent, so a contiguous (B, n0, n1) batch is B n0
//    rows of one launch; K4's launch grid gets the batch as its y extent,
//    each slice's half spectra `batch_pitch` apart, and its clusters stay
//    within one slice.
// 6. Column ranges (K4r, the pencil transform of a row-sharded field): the
//    same kernels on the w + 1 half-spectrum columns src_col .. src_col + w
//    (w a multiple of 8 for the clusters) of all n0 rows, written packed as
//    (n0, 2w): P[:, t] = H[:, src_col + t] and P[:, 2w - t] the mirror of
//    column src_col + t, 1 <= t <= w.  The last column is the block's
//    halo: it is transformed only for its mirror (the extra column of the
//    last cluster tile), so every mirror store stays an aligned 32-byte run
//    and no column is written twice.  Rank r of p, taking src_col = r w
//    with w = n1 / 2p, writes H's columns [r w, r w + w) and
//    [n1 - r w - w, n1 - r w): every column of H once over the ranks (the
//    last rank's halo is the Nyquist column, its mirror itself).
// 7. K4r on the exchange's buffers (the 2-D pencil transform's stage 2).
//    The block's n0 rows arrive as p chunks of n0/p rows, one from each
//    rank, where the receive buffer of all_to_all_single holds them:
//    sender-major (p, B, n0/p, w + 8) complex.  Its output goes to the
//    return exchange's send buffer, destination-major (p, B, n0/p, 2w)
//    f32.  The kernels find row i of a block through `Rows` (its chunk
//    i / rows by a multiply-high, corrected once, then its place in the
//    chunk), a template flag so that K4 and the unchunked K4r keep their
//    arithmetic; no copy joins the chunks before the kernel or cuts its
//    output after it.  The launch shape follows the block's tiles, not n0
//    alone (cuda_fft.range_launch, from a sweep on the card): w / 8 tiles
//    a slice fall from 128 to 32 between 2 and 8 ranks at 4096^2.  A tile's
//    loads, passes and stores follow each other, and the passes wait on
//    shared memory, so what pays is many threads a column on the SMs the
//    tiles fill: up to 132 tiles, clusters of 2 blocks of 576 threads (64 a
//    column); at 32 tiles or fewer, clusters of 16 (past the portable
//    size), whose rows split 16 ways, the cross pass of radix 16 over
//    distributed shared memory; else clusters of 8.  The blocks of the
//    clusters of 8 and 16 take <= 288 threads, a launch bound of their own.
//    These clusters also take columns of up to 24576 rows (an 8th or a
//    16th of them fits in shared memory), where K4 falls back to the tiles
//    of 1 or 2 columns.  The bound: the block read once and its packed
//    columns written once, 8 n0 (w + 1) + 8 n0 w bytes a slice (0.020 ms at
//    4096^2 over 2 ranks).  The target at 4096^2, B = 1, was 0.040 ms over
//    2 ranks and 0.020 over 4; the card gave ~0.068 and ~0.031 against the
//    former launch's ~0.077 and ~0.045 (NVIDIA H100 80GB HBM3, 700 W;
//    PERF.md): a tile's loads, passes and stores follow each other, and a
//    pipelined kernel that overlapped them across tiles lost more to the
//    warps it took from the passes than it won.
// A launch raises the kernel's dynamic shared-memory limit once per size
// and reports any refusal through the returned error code.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxPasses = 8;
constexpr int kTwLo = 128;
constexpr int kSmemLimit = 232448;

struct Pass {
  int radix, m, tw_stride;
  unsigned magic;  // j / m == __umulhi(j, magic) for m > 1
};

struct Plan {
  int n, n_passes;
  Pass p[kMaxPasses];
};

// Where row i of a column block lies (note 7): in chunks of `rows` rows,
// `chunk` apart, rows `pitch` apart within a chunk, batch slices `batch`
// apart (elements of the array).  Unchunked: rows = n0, one chunk.
struct Rows {
  long long batch, chunk;
  int pitch, rows;
  unsigned magic;  // floor((2^32 - 1) / rows): i / rows is umulhi(i, magic) or one more
};

// (by value: a reference to a __grid_constant__ parameter makes its fields
// generic loads where a copy reads them from the constant bank)
template <bool kChunk>
__device__ __forceinline__ long long row_at(const Rows L, int i) {
  if constexpr (!kChunk) {
    return (long long)i * L.pitch;
  } else {
    int c = (int)__umulhi((unsigned)i, L.magic);
    int rem = i - c * L.rows;
    if (rem >= L.rows) {
      c += 1;
      rem -= L.rows;
    }
    return c * L.chunk + (long long)rem * L.pitch;
  }
}

// exp(-2 pi i e / R)
__constant__ float2 kW16[16] = {
    {1.0f, 0.0f}, {9.238795325e-01f, -3.826834324e-01f},
    {7.071067812e-01f, -7.071067812e-01f}, {3.826834324e-01f, -9.238795325e-01f},
    {0.0f, -1.0f}, {-3.826834324e-01f, -9.238795325e-01f},
    {-7.071067812e-01f, -7.071067812e-01f}, {-9.238795325e-01f, -3.826834324e-01f},
    {-1.0f, 0.0f}, {-9.238795325e-01f, 3.826834324e-01f},
    {-7.071067812e-01f, 7.071067812e-01f}, {-3.826834324e-01f, 9.238795325e-01f},
    {0.0f, 1.0f}, {3.826834324e-01f, 9.238795325e-01f},
    {7.071067812e-01f, 7.071067812e-01f}, {9.238795325e-01f, 3.826834324e-01f}};
__constant__ float2 kW3[3] = {
    {1.0f, 0.0f}, {-0.5f, -8.660254038e-01f}, {-0.5f, 8.660254038e-01f}};
__constant__ float2 kW5[5] = {
    {1.0f, 0.0f}, {3.090169944e-01f, -9.510565163e-01f},
    {-8.090169944e-01f, -5.877852523e-01f}, {-8.090169944e-01f, 5.877852523e-01f},
    {3.090169944e-01f, 9.510565163e-01f}};
__constant__ float2 kW7[7] = {
    {1.0f, 0.0f}, {6.234898019e-01f, -7.818314825e-01f},
    {-2.225209340e-01f, -9.749279122e-01f}, {-9.009688679e-01f, -4.338837391e-01f},
    {-9.009688679e-01f, 4.338837391e-01f}, {-2.225209340e-01f, 9.749279122e-01f},
    {6.234898019e-01f, 7.818314825e-01f}};

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}
__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}

// Shared-memory position of element i: one element of padding every 16 and
// every 256, so that the stride-16 accesses of the last pass and the
// stride-256 reads of the digit-reversed output fall on distinct banks.
__device__ __forceinline__ int pad(int i) { return i + (i >> 4) + (i >> 8); }

// x * exp(-2 pi i e / R) for R in {4, 8, 16}; e is a constant after
// unrolling, so quarter turns cost no multiply.
template <int R>
__device__ __forceinline__ float2 rotate(float2 x, int e) {
  const int e16 = (e * (16 / R)) & 15;
  if (e16 == 0) return x;
  if (e16 == 4) return make_float2(x.y, -x.x);
  if (e16 == 8) return make_float2(-x.x, -x.y);
  if (e16 == 12) return make_float2(-x.y, x.x);
  return cmul(x, kW16[e16]);
}

template <int R>
__device__ __forceinline__ float2 root(int e) {
  if constexpr (R == 3) return kW3[e];
  else if constexpr (R == 5) return kW5[e];
  else return kW7[e];
}

// The R-point DFT a[q] <- sum_r a[r] exp(-2 pi i r q / R), in registers.
template <int R>
__device__ __forceinline__ void dft(float2 (&a)[R]) {
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
  } else if constexpr (R == 8 || R == 16) {
    // r = R2 r1 + r2, q = q1 + 4 q2: 4-point DFTs over r1, the twiddle
    // w_R^{r2 q1}, then R2-point DFTs over r2
    constexpr int R2 = R / 4;
    float2 b[R2][4];
#pragma unroll
    for (int r2 = 0; r2 < R2; ++r2) {
      float2 t[4] = {a[r2], a[r2 + R2], a[r2 + 2 * R2], a[r2 + 3 * R2]};
      dft<4>(t);
#pragma unroll
      for (int q1 = 0; q1 < 4; ++q1) b[r2][q1] = rotate<R>(t[q1], r2 * q1);
    }
#pragma unroll
    for (int q1 = 0; q1 < 4; ++q1) {
      float2 u[R2];
#pragma unroll
      for (int r2 = 0; r2 < R2; ++r2) u[r2] = b[r2][q1];
      dft<R2>(u);
#pragma unroll
      for (int q2 = 0; q2 < R2; ++q2) a[q1 + 4 * q2] = u[q2];
    }
  } else {
    float2 out[R];
#pragma unroll
    for (int q = 0; q < R; ++q) {
      float2 s = a[0];
#pragma unroll
      for (int r = 1; r < R; ++r) s = cadd(s, cmul(a[r], root<R>((r * q) % R)));
      out[q] = s;
    }
#pragma unroll
    for (int q = 0; q < R; ++q) a[q] = out[q];
  }
}

// One decimation-in-frequency pass of radix R over a length-n sequence held
// at shared positions pad(a) * S1 + ofs of buf.  Thread j0 takes the
// butterflies j = j0, j0 + T, ... (< n / R).  Butterfly j (g = j / m,
// k = j % m, blocks of L = m R) reads x[g L + k + r m], transforms, scales
// output q by w^{q k tw_stride} from the tables (= w_L^{q k}) and writes it
// to g L + k + q m.  The pass ends in a barrier.
template <int R>
__device__ __forceinline__ void fft_pass(float2* buf, int S1, int ofs, int j0, int T,
                                         int n, const Pass ps, const float2* tlo,
                                         const float2* thi) {
  const int nR = n / R;
  for (int j = j0; j < nR; j += T) {
    int g = j, k = 0;
    if (ps.m > 1) {
      g = (int)__umulhi((unsigned)j, ps.magic);
      k = j - g * ps.m;
    }
    const int base = g * ps.m * R + k;
    float2 a[R];
#pragma unroll
    for (int r = 0; r < R; ++r) a[r] = buf[pad(base + r * ps.m) * S1 + ofs];
    dft<R>(a);
    if (ps.m > 1) {
      const int step = k * ps.tw_stride;
      auto tw = [&](int e) { return cmul(thi[e >> 7], tlo[e & (kTwLo - 1)]); };
      if constexpr (R == 8 || R == 16) {
        // w^q = w^{q1} w^{4 q2} for q = q1 + 4 q2: 3 + R/4 - 1 table
        // lookups instead of R - 1
        float2 lo3[3], hi3[3];
#pragma unroll
        for (int t = 0; t < 3; ++t) lo3[t] = tw((t + 1) * step);
#pragma unroll
        for (int t = 0; t < R / 4 - 1; ++t) hi3[t] = tw(4 * (t + 1) * step);
#pragma unroll
        for (int q = 1; q < R; ++q) {
          const int q1 = q & 3, q2 = q >> 2;
          const float2 w = q2 == 0 ? lo3[q1 - 1]
                           : q1 == 0 ? hi3[q2 - 1]
                                     : cmul(lo3[q1 - 1], hi3[q2 - 1]);
          a[q] = cmul(a[q], w);
        }
      } else {
#pragma unroll
        for (int q = 1; q < R; ++q) a[q] = cmul(a[q], tw(q * step));
      }
    }
#pragma unroll
    for (int q = 0; q < R; ++q) buf[pad(base + q * ps.m) * S1 + ofs] = a[q];
  }
  __syncthreads();
}

// All passes of the plan; afterwards element f of the transform is at
// position rev[f].
__device__ __forceinline__ void fft(float2* buf, int S1, int ofs, int j0, int T,
                                    const Plan& plan, const float2* tlo, const float2* thi) {
  for (int p = 0; p < plan.n_passes; ++p) {
    const Pass ps = plan.p[p];
    switch (ps.radix) {
      case 16: fft_pass<16>(buf, S1, ofs, j0, T, plan.n, ps, tlo, thi); break;
      case 8: fft_pass<8>(buf, S1, ofs, j0, T, plan.n, ps, tlo, thi); break;
      case 4: fft_pass<4>(buf, S1, ofs, j0, T, plan.n, ps, tlo, thi); break;
      case 2: fft_pass<2>(buf, S1, ofs, j0, T, plan.n, ps, tlo, thi); break;
      case 3: fft_pass<3>(buf, S1, ofs, j0, T, plan.n, ps, tlo, thi); break;
      case 5: fft_pass<5>(buf, S1, ofs, j0, T, plan.n, ps, tlo, thi); break;
      case 7: fft_pass<7>(buf, S1, ofs, j0, T, plan.n, ps, tlo, thi); break;
    }
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global.L2::128B [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global.L2::128B [%0], [%1], 8;\n" ::"r"(s), "l"(src));
}

// The twiddle tables lo (kTwLo entries) and hi (n / kTwLo) into smem[0..).
__device__ __forceinline__ void load_tables(float2* smem, const float2* __restrict__ tables,
                                            int n, int tid, int nthreads) {
  for (int e = tid; e < kTwLo + n / kTwLo; e += nthreads) smem[e] = __ldg(tables + e);
}

constexpr int kMaxThreads = 640;  // the kernels' launch bound (<= 102 registers a thread)
constexpr int kMaxThreadsWide = 288;  // that of the clusters of 8 and 16 blocks (9 x 32 threads)

// K3: row pairs (2p, 2p+1) -> half spectra G[2p, :], G[2p+1, :] with row
// pitch `pitch`; a block of T threads for pair p = blockIdx.x.
__global__ void __launch_bounds__(kMaxThreads)
    hartley_rows_kernel(const float* __restrict__ x, float2* __restrict__ G, int pitch,
                        const float2* __restrict__ tables, const short* __restrict__ rev,
                        const __grid_constant__ Plan plan) {
  extern __shared__ __align__(16) float2 smem[];
  const int n1 = plan.n;
  const int T = blockDim.x;
  float2* tlo = smem;
  float2* thi = smem + kTwLo;
  float2* buf = smem + kTwLo + n1 / kTwLo;
  const long long pair = blockIdx.x;
  const float4* xa = reinterpret_cast<const float4*>(x + 2 * pair * n1);
  const float4* xb = xa + n1 / 4;
#pragma unroll 4
  for (int q = threadIdx.x; q < n1 / 4; q += T) {
    const float4 a = __ldg(xa + q), b = __ldg(xb + q);
    float2* z = buf + pad(4 * q);  // 4 q .. 4 q + 3 lie in one run of 16
    z[0] = make_float2(a.x, b.x);
    z[1] = make_float2(a.y, b.y);
    z[2] = make_float2(a.z, b.z);
    z[3] = make_float2(a.w, b.w);
  }
  load_tables(smem, tables, n1, threadIdx.x, T);
  __syncthreads();
  fft(buf, 1, 0, threadIdx.x, T, plan, tlo, thi);

  const int half = n1 / 2;
  float2* ga = G + 2 * pair * pitch;
  float2* gb = ga + pitch;
  for (int t = threadIdx.x; t < half / 2; t += T) {
    float2 A[2], B[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int k = 2 * t + u;
      const float2 z = buf[pad(__ldg(rev + k))];
      const float2 zm = buf[pad(__ldg(rev + (k == 0 ? 0 : n1 - k)))];  // Z_{n-k}; conj below
      A[u] = make_float2(0.5f * (z.x + zm.x), 0.5f * (z.y - zm.y));
      B[u] = make_float2(0.5f * (z.y + zm.y), -0.5f * (z.x - zm.x));
    }
    reinterpret_cast<float4*>(ga)[t] = make_float4(A[0].x, A[0].y, A[1].x, A[1].y);
    reinterpret_cast<float4*>(gb)[t] = make_float4(B[0].x, B[0].y, B[1].x, B[1].y);
  }
  if (threadIdx.x < 4) {  // [half, half + 8): the Nyquist entry, then zeros
    const float2 z = buf[pad(__ldg(rev + half))];
    const bool nyq = threadIdx.x == 0;
    reinterpret_cast<float4*>(ga + half)[threadIdx.x] = make_float4(nyq ? z.x : 0.f, 0.f, 0.f, 0.f);
    reinterpret_cast<float4*>(gb + half)[threadIdx.x] = make_float4(nyq ? z.y : 0.f, 0.f, 0.f, 0.f);
  }
}

// One 16-byte store as written: left to the compiler, the clusters' guarded
// vector stores became four predicated scalar ones (K4 13 % slower)
__device__ __forceinline__ void store4(float* dst, const float (&w)[4]) {
  asm volatile("st.global.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"l"(dst), "f"(w[0]), "f"(w[1]),
               "f"(w[2]), "f"(w[3])
               : "memory");
}

// K4 for long columns (the clusters below do not fit): a block takes the tile
// of TC = 1 or 2 half-spectrum columns c0 .. c0 + TC - 1 (interleaved) and
// stores H[i, c0 .. c0 + TC - 1] and the mirror H[-i, nw - c0 - TC + 1 ..
// nw - c0] of each row (nw = 2 half, the output's width).  Block of T * TC
// threads: T for each column; the grid's y index is the batch slice.  Rows
// of the input and the output are found through `in` and `out` (note 7).
template <int TC, bool kChunk>
__global__ void __launch_bounds__(kMaxThreads)
    hartley_cols_kernel(const float2* __restrict__ G, float* __restrict__ H, int half, int T,
                        const float2* __restrict__ tables, const short* __restrict__ rev,
                        int src_col, int ranged, const __grid_constant__ Rows in,
                        const __grid_constant__ Rows out, const __grid_constant__ Plan plan) {
  extern __shared__ __align__(16) float2 smem[];
  const int n0 = plan.n;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  float2* tlo = smem;
  float2* thi = smem + kTwLo;
  float2* tile = smem + kTwLo + n0 / kTwLo;
  const int c0 = blockIdx.x * TC;
  const int nw = 2 * half;
  // the batch slice folds into the indices, so the pointer parameters stay
  // in the constant bank instead of taking registers
  const long long gb = blockIdx.y * in.batch + src_col + c0;
  const long long ob = blockIdx.y * out.batch;
  for (int i = tid; i < n0; i += nthreads) {
    if constexpr (TC == 1)
      cp_async8(tile + pad(i), G + gb + row_at<kChunk>(in, i));
    else
      cp_async16(tile + pad(i) * TC, G + gb + row_at<kChunk>(in, i));
  }
  asm volatile("cp.async.commit_group;\n" ::);
  load_tables(smem, tables, n0, tid, nthreads);
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
  fft(tile, TC, tid & (TC - 1), tid / TC, T, plan, tlo, thi);

  for (int i = tid; i < n0; i += nthreads) {  // a thread a row
    const int p = pad(__ldg(rev + i));
    float* hl = H + ob + row_at<kChunk>(out, i) + c0;
    float* hm = H + ob + row_at<kChunk>(out, i == 0 ? 0 : n0 - i) + nw - c0;
    float2 v[TC];
#pragma unroll
    for (int c = 0; c < TC; ++c) v[c] = tile[p * TC + c];
    // ranged: the last column (the halo) only for its mirror, which is
    // then stored too (the Nyquist column of the last rank is its own)
    if (TC == 2 && c0 + 1 <= half - ranged) {
      *reinterpret_cast<float2*>(hl) = make_float2(v[0].x - v[0].y, v[TC - 1].x - v[TC - 1].y);
    } else {
#pragma unroll
      for (int c = 0; c < TC; ++c)
        if (c0 + c <= half - ranged) hl[c] = v[c].x - v[c].y;
    }
#pragma unroll
    for (int c = 0; c < TC; ++c)
      if (c0 + c >= 1 && c0 + c < half + ranged) hm[-c] = v[c].x + v[c].y;
  }
}

// K4 by clusters: C = 2, 4, 8 or 16 blocks on C SMs take the 8 columns
// c0 .. c0 + 7 and the extra column c0 + 8, block r the rows r n0/C ..
// (r + 1) n0/C - 1 of all nine (row pieces of 64 + 8 bytes, a part of each
// column).  The first decimation-in-frequency pass, radix C between rows
// k, k + n0/C, ..., runs across the cluster through distributed shared
// memory: block r takes a C-th of the k, transforms the C elements in
// registers and writes output q, times w^{q k}, to block q, so every
// element is read and written by one thread.  Then each block holds the
// length-n0/C transform of its rows' residue: frequency C f + r lies in
// block r at rev[f] (rev and plan of length n0/C, twiddles from the n0
// tables).  A row takes two aligned 32-byte runs, H[i, c0 .. c0 + 7] and
// the mirror H[-i, nw - c0 - 8 .. nw - c0 - 1], two lanes a run, so a
// warp's stores are whole sectors.  Block of 9 T threads: T for each
// column.  The grid's y index is the batch slice; a cluster lies within
// one slice.  Rows of the input and the output through `in` and `out`.
template <int C, bool kChunk>
__global__ void __launch_bounds__(C >= 8 ? kMaxThreadsWide : kMaxThreads)
    hartley_cols_cluster_kernel(const float2* __restrict__ G, float* __restrict__ H, int half,
                                int T, const float2* __restrict__ tables,
                                const short* __restrict__ rev, int src_col, int ranged,
                                const __grid_constant__ Rows in, const __grid_constant__ Rows out,
                                const __grid_constant__ Plan plan) {
  extern __shared__ __align__(16) float2 smem[];
  constexpr int TC = 8;
  cg::cluster_group cluster = cg::this_cluster();
  const int r = (int)cluster.block_rank();
  const int hn = plan.n;  // n0 / C rows a block
  const int n0 = C * hn;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  float2* tlo = smem;
  float2* thi = smem + kTwLo;
  float2* tile = smem + kTwLo + n0 / kTwLo;
  float2* extra = tile + TC * (hn + hn / 16 + hn / 256);
  const int c0 = (blockIdx.x / C) * TC;
  const int nw = 2 * half;
  // columns 1 .. 8 of the run all mirror (ranged: always, the halo included)
  const bool mirror_all = ranged || c0 + TC < half;
  const long long gb = blockIdx.y * in.batch + src_col + c0;
  const long long ob = blockIdx.y * out.batch;
  for (int e = tid; e < hn * (TC / 2); e += nthreads) {
    const int i = e >> 2, q = e & 3;
    cp_async16(tile + pad(i) * TC + 2 * q, G + gb + row_at<kChunk>(in, r * hn + i) + 2 * q);
  }
  if (mirror_all)
    for (int i = tid; i < hn; i += nthreads)
      cp_async8(extra + pad(i), G + gb + row_at<kChunk>(in, r * hn + i) + TC);
  asm volatile("cp.async.commit_group;\n" ::);
  load_tables(smem, tables, n0, tid, nthreads);
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  cluster.sync();  // every part loaded

  // thread roles: column tid % 8 of the tile, or the extra column
  const bool in_tile = tid < T * TC;
  float2* mine = in_tile ? tile : extra;
  const int S1 = in_tile ? TC : 1, ofs = in_tile ? (tid & (TC - 1)) : 0;
  const int j0 = in_tile ? tid >> 3 : tid - T * TC;
  float2* xs[C];
#pragma unroll
  for (int q = 0; q < C; ++q) xs[q] = cluster.map_shared_rank(mine, q);
  for (int k = r * (hn / C) + j0; k < (r + 1) * (hn / C); k += T) {
    const int at = pad(k) * S1 + ofs;
    float2 a[C];
#pragma unroll
    for (int q = 0; q < C; ++q) a[q] = xs[q][at];
    dft<C>(a);
    xs[0][at] = a[0];
#pragma unroll
    for (int q = 1; q < C; ++q) {
      const int e = q * k;
      xs[q][at] = cmul(a[q], cmul(thi[e >> 7], tlo[e & (kTwLo - 1)]));
    }
  }
  cluster.sync();  // the cross pass is done in every part
  fft(mine, S1, ofs, j0, T, plan, tlo, thi);

  const int h = half + 1;
  for (int e = tid; e < 2 * hn; e += nthreads) {
    const int f = e >> 1, u = e & 1;  // two lanes a row: columns 4 u .. 4 u + 3
    const int i = C * f + r;
    const int p = pad(__ldg(rev + f));
    float left[4], right[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float2 v = tile[p * TC + 4 * u + c];
      left[c] = v.x - v.y;
      const int m = TC - 4 * u - c;  // mirror of column c0 + m lands at nw - c0 - 8 + 4 u + c
      const float2 w = m == TC ? extra[p] : tile[p * TC + m];
      right[c] = w.x + w.y;
    }
    float* hl = H + ob + row_at<kChunk>(out, i) + c0 + 4 * u;
    float* hm = H + ob + row_at<kChunk>(out, i == 0 ? 0 : n0 - i) + (nw - c0 - TC + 4 * u);
    if (c0 + TC <= h) {
      store4(hl, left);
    } else {
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (c0 + 4 * u + c < h) hl[c] = left[c];
    }
    if (mirror_all) {
      store4(hm, right);
    } else {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = c0 + TC - 4 * u - c;
        if (col >= 1 && col < half) hm[c] = right[c];
      }
    }
  }
}

// The host's plan, checked: a length-n FFT (n a multiple of 16) whose
// twiddles come from the tables of length n_tab (a multiple of n), each
// pass's stride m the block length L left by the passes before it over its
// radix, the last pass m = 1, the magic multipliers and the twiddle
// strides n_tab / L as the kernels use them.
int make_plan(Plan* plan, int n, int n_tab, const int* passes, int n_passes) {
  if (n <= 0 || n % 16 || n_tab % 256 || n_tab % n || n_passes < 1 || n_passes > kMaxPasses)
    return (int)cudaErrorInvalidValue;
  plan->n = n;
  plan->n_passes = n_passes;
  long long L = n;
  for (int t = 0; t < n_passes; ++t) {
    const int R = passes[4 * t];
    const bool ok_r = R == 16 || R == 8 || R == 4 || R == 2 || R == 3 || R == 5 || R == 7;
    if (!ok_r || L % R) return (int)cudaErrorInvalidValue;
    const long long m = L / R;
    const unsigned magic = (unsigned)passes[4 * t + 2];
    const unsigned long long want =
        m == 1 ? 0ull : ((1ull << 32) + (unsigned long long)m - 1) / (unsigned long long)m;
    if (passes[4 * t + 1] != m || magic != want || passes[4 * t + 3] != n_tab / L)
      return (int)cudaErrorInvalidValue;
    plan->p[t] = Pass{R, (int)m, passes[4 * t + 3], magic};
    L = m;
  }
  return L == 1 ? 0 : (int)cudaErrorInvalidValue;
}

// Raise a kernel's dynamic shared-memory limit to `bytes` unless an earlier
// launch already did (kept per kernel in *done).
template <typename K>
int allow_smem(K kernel, size_t bytes, int* done) {
  if ((int)bytes <= *done) return 0;
  const int err = (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (!err) *done = (int)bytes;
  return err;
}

size_t tables_bytes(int n) { return (size_t)(kTwLo + n / kTwLo) * sizeof(float2); }

size_t buffer_bytes(int n) { return (size_t)(n + n / 16 + n / 256) * sizeof(float2); }

int rows_smem_done;

template <int C, bool kChunk>
int launch_cluster(const float2* g, float* H, int half, int T, int grid, int batch,
                   const float2* tab, const short* rv, int src_col, int ranged, const Rows& in,
                   const Rows& out, const Plan& plan, size_t smem, cudaStream_t s) {
  const auto kernel = hartley_cols_cluster_kernel<C, kChunk>;
  static int smem_done = 0, wide_done = 0;
  int err = allow_smem(kernel, smem, &smem_done);
  if (err) return err;
  if (C > 8 && !wide_done) {  // 16 blocks: past the portable cluster size
    err = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err) return err;
    wide_done = 1;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C * grid, batch);
  cfg.blockDim = dim3(T * 9);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = C;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = (int)cudaLaunchKernelEx(&cfg, kernel, g, H, half, T, tab, rv, src_col, ranged, in, out,
                                plan);
  if (err) return err;
  return (int)cudaGetLastError();
}

template <int TC, bool kChunk>
int launch_tiles(const float2* g, float* H, int half, int T, int grid, int batch,
                 const float2* tab, const short* rv, int src_col, int ranged, const Rows& in,
                 const Rows& out, const Plan& plan, size_t smem, cudaStream_t s) {
  static int smem_done = 0;
  const int err = allow_smem(hartley_cols_kernel<TC, kChunk>, smem, &smem_done);
  if (err) return err;
  hartley_cols_kernel<TC, kChunk><<<dim3(grid, batch), T * TC, smem, s>>>(
      g, H, half, T, tab, rv, src_col, ranged, in, out, plan);
  return (int)cudaGetLastError();
}

template <bool kChunk>
int launch_cols(int parts, int tc, const float2* g, float* H, int half, int T, int grid,
                int batch, const float2* tab, const short* rv, int src_col, int ranged,
                const Rows& in, const Rows& out, const Plan& plan, size_t smem, cudaStream_t s) {
  switch (parts) {
    case 2: return launch_cluster<2, kChunk>(g, H, half, T, grid, batch, tab, rv, src_col, ranged,
                                             in, out, plan, smem, s);
    case 4: return launch_cluster<4, kChunk>(g, H, half, T, grid, batch, tab, rv, src_col, ranged,
                                             in, out, plan, smem, s);
    case 8: return launch_cluster<8, kChunk>(g, H, half, T, grid, batch, tab, rv, src_col, ranged,
                                             in, out, plan, smem, s);
    case 16: return launch_cluster<16, kChunk>(g, H, half, T, grid, batch, tab, rv, src_col,
                                               ranged, in, out, plan, smem, s);
    default:
      return tc == 2 ? launch_tiles<2, kChunk>(g, H, half, T, grid, batch, tab, rv, src_col,
                                               ranged, in, out, plan, smem, s)
                     : launch_tiles<1, kChunk>(g, H, half, T, grid, batch, tab, rv, src_col,
                                               ranged, in, out, plan, smem, s);
  }
}

unsigned row_magic(int rows) { return 0xFFFFFFFFu / (unsigned)rows; }

}  // namespace

extern "C" int nt_hartley_rows(const void* x, void* G, int n0, int n1, int pitch,
                               const void* tables, const void* rev, const int* passes,
                               int n_passes, int T, void* stream) {
  Plan plan;
  int err = make_plan(&plan, n1, n1, passes, n_passes);
  if (err) return err;
  if (T < 1 || n0 % 2 || T > kMaxThreads || pitch % 8 || pitch < n1 / 2 + 8)
    return (int)cudaErrorInvalidValue;
  const size_t smem = tables_bytes(n1) + buffer_bytes(n1);
  if (smem > (size_t)kSmemLimit) return (int)cudaErrorInvalidValue;
  err = allow_smem(hartley_rows_kernel, smem, &rows_smem_done);
  if (err) return err;
  hartley_rows_kernel<<<n0 / 2, T, smem, (cudaStream_t)stream>>>(
      (const float*)x, (float2*)G, pitch, (const float2*)tables, (const short*)rev, plan);
  return (int)cudaGetLastError();
}

// parts 0: blocks over tiles of tc = 1 or 2 columns; 2, 4, 8 or 16:
// clusters of that many blocks over tc = 8 columns and the extra one
// (passes and rev of length n0 / parts).  `batch` half spectra,
// `batch_pitch` complex apart, into `batch` dense (n0, n1) arrays: the
// launch grid's y extent.  With n_cols = w > 0 (K4r) the columns src_col
// .. src_col + w of the half spectra of width n1 go to `batch` packed
// (n0, 2w) arrays (note 6); with chunks = p > 1 too, on the exchange's
// buffers (note 7): the input (p, batch, n0/p, pitch), its chunks
// `chunk_pitch` and its slices `batch_pitch` apart, the output (p, batch,
// n0/p, 2w).
extern "C" int nt_hartley_cols(const void* G, void* H, int n0, int n1, int pitch,
                               long long batch_pitch, long long chunk_pitch, int chunks,
                               int batch, const void* tables, const void* rev, const int* passes,
                               int n_passes, int T, int tc, int parts, int src_col, int n_cols,
                               void* stream) {
  if (parts != 0 && parts != 2 && parts != 4 && parts != 8 && parts != 16)
    return (int)cudaErrorInvalidValue;
  Plan plan;
  int err = make_plan(&plan, parts ? n0 / parts : n0, n0, passes, n_passes);
  if (err) return err;
  const bool ok_tc = parts ? tc == 8 : tc == 1 || tc == 2;
  const int cols = tc + (parts != 0);  // the tile and the extra column
  const int ranged = n_cols > 0;
  const int half = ranged ? n_cols : n1 / 2;  // the output's width is 2 half
  const int max_threads = parts >= 8 ? kMaxThreadsWide : kMaxThreads;
  const int rows = chunks > 0 ? n0 / chunks : 0;  // rows a chunk
  // a ranged cluster's last tile reads the halo column c0 + 8 = src_col + half, no further
  const int reach = ranged && parts ? 1 : tc;
  if (!ok_tc || T < 1 || T * cols > max_threads || n1 <= 0 || n1 % 256 || pitch % 8 ||
      pitch < src_col + half + reach || (parts && (n0 / parts) % parts) || batch < 1 ||
      batch > 65535 || batch_pitch % 8 || src_col < 0 || src_col % 8 ||
      (ranged && (n_cols % 8 || src_col + n_cols > n1 / 2)) || (!ranged && src_col) ||
      chunks < 1 || n0 % chunks || (chunks > 1 && !ranged))
    return (int)cudaErrorInvalidValue;
  if (chunks == 1 ? batch > 1 && batch_pitch < (long long)n0 * pitch
                  : (batch > 1 && batch_pitch < (long long)rows * pitch) || chunk_pitch % 8 ||
                        chunk_pitch < (batch - 1) * batch_pitch + (long long)rows * pitch)
    return (int)cudaErrorInvalidValue;
  const size_t smem = tables_bytes(n0) + (size_t)cols * buffer_bytes(parts ? n0 / parts : n0);
  if (smem > (size_t)kSmemLimit) return (int)cudaErrorInvalidValue;
  // tiles over columns 0 .. half (ranged clusters: 0 .. half - 1, the halo
  // their last tile's extra column)
  const int grid = (half + 1 - (ranged && parts) + tc - 1) / tc;
  const int nw = 2 * half;
  const Rows in{batch_pitch, chunk_pitch, pitch, rows, row_magic(rows)};
  const Rows out = chunks == 1
      ? Rows{(long long)n0 * nw, 0, nw, n0, row_magic(n0)}
      : Rows{(long long)rows * nw, (long long)batch * rows * nw, nw, rows, row_magic(rows)};
  const float2* g = (const float2*)G;
  const float2* tab = (const float2*)tables;
  const short* rv = (const short*)rev;
  cudaStream_t s = (cudaStream_t)stream;
  if (chunks == 1)
    return launch_cols<false>(parts, tc, g, (float*)H, half, T, grid, batch, tab, rv, src_col,
                              ranged, in, out, plan, smem, s);
  return launch_cols<true>(parts, tc, g, (float*)H, half, T, grid, batch, tab, rv, src_col,
                           ranged, in, out, plan, smem, s);
}
