// K5 and K6 of the spherical-harmonic synthesis: the Legendre contraction
// of the packed real alm against the normalised associated Legendre
// functions on the rings of a north/south symmetric grid, and its exact
// adjoint.
//
// Replaces nifty_tpu/ops/sht.py:338 nifty_legendre_contract, the JAX
// package's own XLA primitive (not a Pallas kernel): a lax.scan over l, 8
// steps a scan step, that generates lambda_{l,m}(theta_r) by the stable
// three-term recurrence and contracts it at once, so that nothing of size
// O(lmax mmax rings) is held in memory, with the hemisphere fold
// (:253-335): lambda_{l,m}(pi - theta) = (-1)^(l+m) lambda_{l,m}(theta).
//
//   K5: F[b, r, m] = sum_{l=m}^{lmax} lambda_{l,m}(theta_r) c[b, l, m] and
//       F[b, R-1-r, m] = sum_l (-1)^(l+m) lambda_{l,m}(theta_r) c[b, l, m]
//       for the northern rings r < Rh = (R+1)/2 (the second only where
//       R-1-r > r), each for the cosine and the sine coefficients, written
//       interleaved as F[b, ring, m] = (cos part, sin part);
//   K6: g[b, l, m] = sum_{r<Rh} lambda_{l,m}(theta_r)
//       (G[b, r, m] + (-1)^(l+m) G[b, R-1-r, m]), written back into the
//       packed layout (the m = 0 sine part is no coefficient and is
//       dropped, as the packing's mask drops it).
//
// The packed real alm: all m = 0 coefficients for l = 0..lmax first, then
// for each m >= 1 the (re, im) pairs for l = m..lmax; col_off[m] is where
// column m starts.
//
// What bounds them on the card: operations, and at large batches the ring
// side's bytes.  The work is Rh sum_m (lmax - m + 1) (l, m, ring) triples,
// each a step of the recurrence (two multiplies and an FMA in float64) and
// 2 B multiply-adds; ~67 M triples at nside 256, lmax 512.  The recurrence
// stays float64: lambda_{m,m} ~ sin^m theta drops below float32's normal
// range for m >~ 87 / |ln sin theta|, while lambda_{l,m} for larger l grows
// back to O(0.1).  The source is built without --use_fast_math (no flushed
// denormals).
//
// Batches below 8 (the spherical field's: a metric apply, 2 or 4 samples)
// take the CUDA-core kernels:
//
// 1. A balanced l-triangle.  Column m walks lmax - m + 1 steps, so a block
//    takes the pair of columns (p, mmax - p) from the plan's `pairs` table
//    (p = 0..mmax/2; the middle column of an even mmax pairs with none) and
//    runs one after the other: every block walks 2 lmax - mmax + 2 steps,
//    and no wave ends on one long column.  Rings run across the threads:
//    ring r = (chunk K + k) threads + tid for the thread's k < K rings
//    (independent recurrences interleaved), so the threads of a block walk
//    the same l and read the same coefficients.
// 2. Columns staged by bulk copies.  A block copies the rows ab[m, m..lmax]
//    of its columns (and in K5 each sample's packed alm column) into shared
//    memory with cp.async.bulk on one mbarrier: the 16-byte-aligned middle
//    of each span in one copy, the <= 3 words before and after it by plain
//    loads (a column starts at any float offset, and so may the input).  The
//    loops then read only shared memory (broadcasts); no per-sample branch
//    is left in them (a missing sample reads sample 0's column and is not
//    stored).
// 3. Up to 4 samples a block (blockIdx.z over groups of 4), lambda rounded
//    to float32 once a triple and contracted in float32; both hemispheres
//    from one recurrence (even and odd l + m summed apart, the loop unrolled
//    by two so the parity is static).  K6 keeps, for a tile of T = 16 / NB
//    consecutive l, the 32 partial sums of its rings in registers and
//    reduces the tile once: a transposing butterfly over the warp (31
//    shuffles leave lane j the sum of value j) and the warps' sums added in
//    warp order in shared memory.  A block holds up to 1,024 northern rings
//    (256 threads x 4), so up to nside 512 K6 is one launch; beyond, the
//    per-chunk sums go to a scratch buffer and a second launch adds them in
//    chunk order.
//
// Batches of 8 or more take the float64 tensor cores (mma.sync m16n8k4:
// the m8n8k4 shape runs at half its rate on an H100, bench/dmma_bench.py),
// 8 samples (16 columns: cos and sin) a block, the recurrence run once for
// them and lambda fed to the products in float64, the alm or cotangent
// converted once, the result rounded once:
//
// 4. K5: 8 consecutive columns a block, one a warp, over 32 rings (a lane a
//    ring); each tile of 8 l goes through the warp's own shared rows
//    (lambda, rings x l) into the product with the coefficients (l x 16),
//    even and odd parity apart, with no block barrier in the loop; the 8
//    columns leave through a shared tile in 64-byte runs.  At a batch of
//    256 the ring side (67 MB at nside 64) outgrows the L2 cache, and one
//    column a block spent a 32-byte sector on every 8 bytes stored.
// 5. K6: a pair a block, 1 ring a thread up to 256 northern rings and 2 above
//    (as in 1), a tile of 16 l (8 of each parity) a step: each warp
//    multiplies its 32 or 64 rings' folded cotangents
//    (registers, float32) by lambda (rings x l, shared, two buffers), and
//    the warps' tiles are added in warp order (one barrier a tile); up to
//    512 northern rings a launch, beyond that the second launch as in 3.
//
// K6 gives the same bits every call: fixed orders of summation everywhere,
// no atomics.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

struct SphereGeom {
  int B, size, lmax, mmax, R, Rh;
};

constexpr int kMaxThreads = 256;    // CUDA-core kernels
constexpr int kMmaSamples = 8;      // samples a tensor-core block serves (16 columns)
constexpr int kMmaThreadsK5 = 256;  // a tensor-core K5 block: 8 warps, a column each, 32 rings
constexpr int kMmaThreadsK6 = 256;  // a tensor-core K6 block at most (1 or 2 rings a thread)
constexpr int kLamPad = 4;          // doubles after each lambda-tile row: conflict-free fragments

int blocks_for(long long n, int per_block) { return (int)((n + per_block - 1) / per_block); }

// ---- staging into shared memory ----------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// n 4-byte words from src (any 4-byte-aligned address) to a shared-memory
// slot (16-byte aligned, slot_words(n) long); src[0] lands at slot + lead
struct Span {
  const float* src;
  float* slot;
  int n;
};

__device__ __forceinline__ int slot_words(int n) { return (n + 6) & ~3; }
__device__ __forceinline__ int span_lead(const float* src) { return (int)(((uintptr_t)src >> 2) & 3); }
__device__ __forceinline__ int span_head(const float* src, int n) {
  return min(n, (4 - span_lead(src)) & 3);
}
__device__ __forceinline__ int span_body(const float* src, int n) {
  return ((n - span_head(src, n)) >> 2) << 2;
}
__device__ __forceinline__ float* span_data(const Span& s) { return s.slot + span_lead(s.src); }

// Every thread calls this with the same spans (get(i), i < n_spans); on
// return, after wait_staged, the block's shared memory holds them.
template <class Get>
__device__ void stage(int n_spans, Get get, uint64_t* bar) {
  const int tid = threadIdx.x;
  if (tid == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar)) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    uint32_t bytes = 0;
    for (int i = 0; i < n_spans; ++i) {
      const Span s = get(i);
      bytes += 4u * span_body(s.src, s.n);
    }
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
                 "r"(bytes)
                 : "memory");
    for (int i = 0; i < n_spans; ++i) {
      const Span s = get(i);
      const int h = span_head(s.src, s.n), body = span_body(s.src, s.n);
      if (body > 0)
        asm volatile(
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
            "[%3];\n" ::"r"(smem_u32(span_data(s) + h)),
            "l"(s.src + h), "r"(4 * body), "r"(smem_u32(bar))
            : "memory");
    }
  }
  for (int e = tid; e < 6 * n_spans; e += blockDim.x) {  // the words around each bulk copy
    const Span s = get(e / 6);
    const int q = e % 6, h = span_head(s.src, s.n), body = span_body(s.src, s.n);
    const int w = q < 3 ? q : h + body + q - 3;
    if (q < 3 ? w < h : w < s.n) span_data(s)[w] = s.src[w];
  }
}

__device__ __forceinline__ void wait_staged(uint64_t* bar) {
  __syncthreads();  // the barrier's initialisation, and the plain words
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar))
        : "memory");
  } while (!done);
}

// The block's columns and the shared-memory layout of the kernels that walk
// a column pair (all but the tensor-core K5): the ab rows of both columns first (n_ab(0) + n_ab(1) entries and
// kAbPad more, which a tile running past lmax reads and discards), then (K5)
// each sample's two alm column slots.  Fields by column through selects, not
// arrays: an array indexed by the column loop would land in local memory.
constexpr int kAbPad = 16;

struct Pair {
  int m0, m1;    // m1 < 0: the self-paired middle column
  int n0, n1;    // l = m..lmax
  int len0, len1;  // packed alm words of the column
  int w0, w1;    // their slots
  int co0, co1;  // where they start in a sample's packed alm

  __device__ Pair(int2 p, int lmax, const int* col_off)
      : m0(p.x), m1(p.y), co0(col_off[p.x]), co1(col_off[max(p.y, 0)]) {
    n0 = lmax - m0 + 1;
    n1 = m1 >= 0 ? lmax - m1 + 1 : 0;
    len0 = m0 == 0 ? lmax + 1 : 2 * n0;
    len1 = m1 < 0 ? 0 : m1 == 0 ? lmax + 1 : 2 * n1;
    w0 = slot_words(len0);
    w1 = m1 >= 0 ? slot_words(len1) : 0;
  }
  __device__ int m(int c) const { return c ? m1 : m0; }
  __device__ int n_ab(int c) const { return c ? n1 : n0; }
  __device__ int len(int c) const { return c ? len1 : len0; }
  __device__ int co(int c) const { return c ? co1 : co0; }
  __device__ int ab_words() const { return 4 * (n0 + n1 + kAbPad); }
  __device__ int sample_words() const { return w0 + w1; }
};

__device__ __forceinline__ Span ab_span(const double2* ab, const Pair& p, float* smem, int c,
                                        int lmax) {
  const int m = max(p.m(c), 0);
  return Span{reinterpret_cast<const float*>(ab + (size_t)m * (lmax + 1) + m),
              smem + (c ? 4 * p.n0 : 0), 4 * p.n_ab(c)};
}

// sample b's column c, in the slot of the block's sample s
__device__ __forceinline__ Span alm_span(const float* alm, const Pair& p, float* smem, int b, int s,
                                         int c, const SphereGeom& g) {
  return Span{alm + (size_t)b * g.size + p.co(c),
              smem + p.ab_words() + s * p.sample_words() + (c ? p.w0 : 0), p.len(c)};
}

// lambda_{m,m} .. by the recurrence on the block's shared rows: one step to l - m = d
__device__ __forceinline__ void advance(const double2& c2, double x, double& p0, double& p1) {
  const double pn = fma(c2.x * x, p1, -(c2.y * p0));
  p0 = p1;
  p1 = pn;
}

// ---- K5 on the CUDA cores: B < 8 ---------------------------------------------------

template <int NB, int K>
__global__ void __launch_bounds__(kMaxThreads)
legendre_contract_kernel(const float* __restrict__ alm, const double2* __restrict__ ab,
                         const double* __restrict__ seed, const double* __restrict__ ct,
                         const int* __restrict__ col_off, const int2* __restrict__ pairs,
                         float2* __restrict__ out, SphereGeom g) {
  extern __shared__ __align__(16) float smem[];
  __shared__ uint64_t bar;
  const int tid = threadIdx.x, nt = blockDim.x;
  const Pair P(pairs[blockIdx.y], g.lmax, col_off);
  const int b0 = blockIdx.z * NB, nb = min(NB, g.B - b0);
  auto span = [&](int i) -> Span {
    if (i < 2) return ab_span(ab, P, smem, i, g.lmax);
    return alm_span(alm, P, smem, b0 + ((i - 2) >> 1), (i - 2) >> 1, (i - 2) & 1, g);
  };
  stage(2 + 2 * nb, span, &bar);
  wait_staged(&bar);

  const int M = g.mmax + 1;
  const double2* ab_s = reinterpret_cast<const double2*>(smem);
  for (int c = 0; c < 2; ++c) {
    const int m = P.m(c);
    if (m < 0) break;
    const double2* abc = ab_s + (c ? P.n0 : 0);  // abc[l - m]
    const bool sine = m > 0;
    const int step = sine ? 2 : 1;  // the packed stride along l
    const float* a[NB];
#pragma unroll
    for (int b = 0; b < NB; ++b) a[b] = b < nb ? span_data(span(2 + 2 * b + c)) : a[0];

    double x[K], p0[K], p1[K];
    float ec[K][NB], es[K][NB], oc[K][NB], os[K][NB];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int r = (blockIdx.x * K + k) * nt + tid;
      const bool ring = r < g.Rh;
      x[k] = ring ? ct[r] : 0.0;
      p1[k] = ring ? seed[(size_t)m * g.Rh + r] : 0.0;  // a ring past the last: lambda = 0
      p0[k] = 0.0;
#pragma unroll
      for (int b = 0; b < NB; ++b) ec[k][b] = es[k][b] = oc[k][b] = os[k][b] = 0.f;
    }
    // the step to l - m = d (none for d = 0: lambda_{m,m} itself) and its terms, into the
    // odd or even sums
    auto term = [&](auto odd, auto step_first, int d) {
      if (decltype(step_first)::value) {
        const double2 c2 = abc[d];
#pragma unroll
        for (int k = 0; k < K; ++k) advance(c2, x[k], p0[k], p1[k]);
      }
      float cc[NB], cs[NB];
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        cc[b] = a[b][step * d];
        cs[b] = sine ? a[b][step * d + 1] : 0.f;
      }
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const float lam = (float)p1[k];
#pragma unroll
        for (int b = 0; b < NB; ++b) {
          if (decltype(odd)::value) {
            oc[k][b] = fmaf(lam, cc[b], oc[k][b]);
            os[k][b] = fmaf(lam, cs[b], os[k][b]);
          } else {
            ec[k][b] = fmaf(lam, cc[b], ec[k][b]);
            es[k][b] = fmaf(lam, cs[b], es[k][b]);
          }
        }
      }
    };
    const int n_l = g.lmax - m + 1;
    const std::true_type yes;
    const std::false_type no;
    term(no, no, 0);
    int d = 1;
    for (; d + 1 < n_l; d += 2) {
      term(yes, yes, d);
      term(no, yes, d + 1);
    }
    if (d < n_l) term(yes, yes, d);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int r = (blockIdx.x * K + k) * nt + tid, rs = g.R - 1 - r;
      if (r >= g.Rh) continue;
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        if (b >= nb) continue;
        const size_t row = (size_t)(b0 + b) * g.R;
        out[(row + r) * M + m] = make_float2(ec[k][b] + oc[k][b], es[k][b] + os[k][b]);
        if (rs > r) out[(row + rs) * M + m] = make_float2(ec[k][b] - oc[k][b], es[k][b] - os[k][b]);
      }
    }
  }
}

// ---- K6 on the CUDA cores: B < 8 ---------------------------------------------------

// v[j] summed over the warp's lanes lands in lane j's v[0]: a butterfly
// that halves the values each round (31 shuffles), in a fixed order
template <int H>
__device__ __forceinline__ void warp_transpose_sum(float (&v)[32], int lane) {
  const bool up = lane & H;
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const float send = up ? v[i] : v[i + H];
    const float keep = up ? v[i + H] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, H);
  }
  if constexpr (H > 1) warp_transpose_sum<H / 2>(v, lane);
}

// dst: the per-chunk sums (n_chunks, B, size), or the result (B, size)
// itself when there is one chunk
template <int NB, int K>
__global__ void __launch_bounds__(kMaxThreads)
legendre_contract_t_kernel(const float* __restrict__ cot, const double2* __restrict__ ab,
                           const double* __restrict__ seed, const double* __restrict__ ct,
                           const int* __restrict__ col_off, const int2* __restrict__ pairs,
                           float* __restrict__ dst, SphereGeom g) {
  constexpr int T = 16 / NB;  // l a tile: 2 NB T = 32 partial sums a thread
  extern __shared__ __align__(16) float smem[];
  __shared__ uint64_t bar;
  __shared__ float red[2][kMaxThreads / 32][32];
  const int tid = threadIdx.x, nt = blockDim.x, lane = tid & 31, warp = tid >> 5;
  const Pair P(pairs[blockIdx.y], g.lmax, col_off);
  const int b0 = blockIdx.z * NB, nb = min(NB, g.B - b0);
  stage(2, [&](int i) { return ab_span(ab, P, smem, i, g.lmax); }, &bar);
  wait_staged(&bar);

  const int M = g.mmax + 1;
  const double2* ab_s = reinterpret_cast<const double2*>(smem);
  int it = 0;  // tiles so far: the reduction buffer alternates
  for (int c = 0; c < 2; ++c) {
    const int m = P.m(c);
    if (m < 0) break;
    const double2* abc = ab_s + (c ? P.n0 : 0);
    double x[K], p0[K], p1[K];
    float2 ev[K][NB], od[K][NB];  // G_north +- G_south
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int r = (blockIdx.x * K + k) * nt + tid, rs = g.R - 1 - r;
      const bool ring = r < g.Rh;
      x[k] = ring ? ct[r] : 0.0;
      p1[k] = ring ? seed[(size_t)m * g.Rh + r] : 0.0;
      p0[k] = 0.0;
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        float2 n = make_float2(0.f, 0.f), s = make_float2(0.f, 0.f);
        if (ring && b < nb) {
          const size_t row = (size_t)(b0 + b) * g.R;
          const float* pn = cot + 2 * ((row + r) * M + m);
          n = make_float2(pn[0], pn[1]);
          if (rs > r) {
            const float* ps = cot + 2 * ((row + rs) * M + m);
            s = make_float2(ps[0], ps[1]);
          }
        }
        ev[k][b] = make_float2(n.x + s.x, n.y + s.y);
        od[k][b] = make_float2(n.x - s.x, n.y - s.y);
      }
    }
    const int n_l = g.lmax - m + 1;
    for (int t0 = 0; t0 < n_l; t0 += T, ++it) {
      float v[32];
#pragma unroll
      for (int t = 0; t < T; ++t) {  // l - m = t0 + t; past lmax the sums are not stored
        if (t > 0 || t0 > 0) {
          const double2 c2 = abc[t0 + t];
#pragma unroll
          for (int k = 0; k < K; ++k) advance(c2, x[k], p0[k], p1[k]);
        }
        float lam[K];
#pragma unroll
        for (int k = 0; k < K; ++k) lam[k] = (float)p1[k];
#pragma unroll
        for (int b = 0; b < NB; ++b) {
          float vc = 0.f, vs = 0.f;
#pragma unroll
          for (int k = 0; k < K; ++k) {
            const float2 f = (t & 1) ? od[k][b] : ev[k][b];
            vc = fmaf(lam[k], f.x, vc);
            vs = fmaf(lam[k], f.y, vs);
          }
          v[(t * NB + b) * 2] = vc;
          v[(t * NB + b) * 2 + 1] = vs;
        }
      }
      warp_transpose_sum<16>(v, lane);
      red[it & 1][warp][lane] = v[0];
      __syncthreads();
      if (tid < 32) {
        float s = 0.f;
        for (int w = 0; w < (nt >> 5); ++w) s += red[it & 1][w][tid];
        const int part = tid & 1, b = (tid >> 1) % NB, d = t0 + (tid >> 1) / NB;
        if (d < n_l && b < nb && (m > 0 || part == 0))
          dst[((size_t)blockIdx.x * g.B + b0 + b) * g.size + P.co(c) +
              (m > 0 ? 2 * d + part : d)] = s;
      }
    }
  }
}

// ---- K5 and K6 on the float64 tensor cores: B >= 8 --------------------------------

// d += a b with mma.m16n8k4.f64 (g = lane / 4, t = lane % 4): A 16x4 with
// a[h] at (g + 8 h, t), B 4x8 with b at (t, g), D 16x8 with d[2 h + i] at
// (g + 8 h, 2 t + i).  The m8n8k4 shape runs at half its rate on an H100
// (bench/dmma_bench.py).
__device__ __forceinline__ void mma1684(double (&d)[4], double a0, double a1, double b) {
  asm volatile(
      "mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, {%4, %5}, {%6}, "
      "{%0, %1, %2, %3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a0), "d"(a1), "d"(b));
}

// The recurrence's coefficients (a_{l,m}, b_{l,m}) for l - m = d, d clamped
// into the column (a tile running past lmax reads a finite value and drops it)
__device__ __forceinline__ double2 ab_at(const double2* ab, int m, int d, int n_l, int lmax) {
  return __ldg(ab + (size_t)m * (lmax + 1) + m + min(d, n_l - 1));
}

// blockIdx: (chunk of 32 rings, group of 8 consecutive columns, group of 8
// samples; `pairs` unused, the signature is the other kernels').  Warp w takes column m = 8 blockIdx.y + w over the chunk's rings
// (lane r runs ring r's recurrence), as 2 row tiles of 16 rings by 2 column
// tiles of the 16 columns (sample, part): each tile of 8 l goes through the
// warp's own shared rows, so the loop needs no block barrier, and the next
// tile's coefficients load during the products.  The block's 8 columns
// leave through a shared tile in 64-byte runs: at a batch of 256 the ring
// side outgrows the L2 cache, and a column a block would spend a 32-byte
// sector on every 8 bytes.
__global__ void __launch_bounds__(kMmaThreadsK5)
legendre_contract_mma_kernel(const float* __restrict__ alm, const double2* __restrict__ ab,
                             const double* __restrict__ seed, const double* __restrict__ ct,
                             const int* __restrict__ col_off, const int2* __restrict__ pairs,
                             float2* __restrict__ out, SphereGeom g) {
  constexpr int S = kMmaSamples, RW = 32, CW = kMmaThreadsK5 / 32, LDW = RW + kLamPad;
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  double* lam = reinterpret_cast<double*>(smem) + warp * 8 * LDW;  // the warp's [8][LDW]
  float2* tile = reinterpret_cast<float2*>(reinterpret_cast<double*>(smem) + CW * 8 * LDW);
  const int m = blockIdx.y * CW + warp, b0 = blockIdx.z * S, M = g.mmax + 1;
  if (m < M) {
    const int n_l = g.lmax - m + 1, r = blockIdx.x * RW + lane;
    const bool ring = r < g.Rh;
    const double x = ring ? ct[r] : 0.0;
    double p1 = ring ? seed[(size_t)m * g.Rh + r] : 0.0, p0 = 0.0;
    const int part = gq & 1;  // this lane's B operands: column j = 8 n + gq (sample j / 2, part j % 2)
    const float* a[2];
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      const int b = b0 + 4 * n + (gq >> 1);
      a[n] = b < g.B && (m > 0 || part == 0) ? alm + (size_t)b * g.size + col_off[m] : nullptr;
    }
    auto coeffs = [&](int t0, double (&bf)[2][2]) {  // rows l - m = t0 + 2 tq + q
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int d = t0 + 2 * tq + q;
#pragma unroll
        for (int n = 0; n < 2; ++n)
          bf[q][n] = a[n] && d < n_l ? (double)__ldg(a[n] + (m > 0 ? 2 * d + part : d)) : 0.0;
      }
    };
    double acc[2][2][2][4];  // [parity][row tile][column tile][4]
#pragma unroll
    for (int q = 0; q < 2; ++q)
#pragma unroll
      for (int k = 0; k < 2; ++k)
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[q][k][n][e] = 0.0;
    double bf[2][2], bn[2][2];
    coeffs(0, bf);
    for (int t0 = 0; t0 < n_l; t0 += 8) {
#pragma unroll
      for (int t = 0; t < 8; ++t) {  // rows 4 q + i hold l - m = t0 + 2 i + q
        if (t > 0 || t0 > 0) advance(ab_at(ab, m, t0 + t, n_l, g.lmax), x, p0, p1);
        lam[((t & 1) * 4 + (t >> 1)) * LDW + lane] = ring && t0 + t < n_l ? p1 : 0.0;
      }
      if (t0 + 8 < n_l) coeffs(t0 + 8, bn);
      __syncwarp();
#pragma unroll
      for (int q = 0; q < 2; ++q)
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          const double* la = lam + (q * 4 + tq) * LDW + k * 16 + gq;
          const double a0 = la[0], a1 = la[8];
#pragma unroll
          for (int n = 0; n < 2; ++n) mma1684(acc[q][k][n], a0, a1, bf[q][n]);
        }
#pragma unroll
      for (int q = 0; q < 2; ++q)
#pragma unroll
        for (int n = 0; n < 2; ++n) bf[q][n] = bn[q][n];
      __syncwarp();
    }
    // D: ring row 16 k + 8 h + gq, column 2 tq + e (sample 4 n + tq, part e)
#pragma unroll
    for (int k = 0; k < 2; ++k)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          const double* e = acc[0][k][n] + 2 * h;
          const double* o = acc[1][k][n] + 2 * h;
          float2* tb = tile + ((4 * n + tq) * 2 * RW + 16 * k + 8 * h + gq) * CW + warp;
          tb[0] = make_float2((float)(e[0] + o[0]), (float)(e[1] + o[1]));
          tb[RW * CW] = make_float2((float)(e[0] - o[0]), (float)(e[1] - o[1]));
        }
  }
  __syncthreads();
  for (int e = tid; e < S * 2 * RW * CW; e += blockDim.x) {  // CW consecutive threads: a row's run
    const int i = e % CW, row = e / CW, rl = row % (2 * RW), b = b0 + row / (2 * RW);
    const int mm = blockIdx.y * CW + i;
    const int rn = blockIdx.x * RW + (rl < RW ? rl : rl - RW), rr = rl < RW ? rn : g.R - 1 - rn;
    if (mm < M && b < g.B && rn < g.Rh && (rl < RW || rr > rn))
      out[((size_t)b * g.R + rr) * M + mm] = tile[e];
  }
}

// blockIdx: (chunk of K blockDim.x <= 512 rings, pair, group of 8 samples);
// a thread runs the recurrence of rings tid + k blockDim.x (k < K) of the
// chunk a tile of 16 l ahead of the products (two lambda buffers), warp w
// reduces rings 32 K w .. 32 K (w + 1) - 1 as 8 K steps of 4 with the
// product D^T (16 columns x 8 l of a parity) += G^T (16 columns x 4 rings,
// the folded cotangents, in registers as float32) x lambda (4 rings x 8 l);
// the warps' tiles meet in shared memory (two buffers, one barrier a tile),
// added in warp order.
template <int K>
__global__ void __launch_bounds__(kMmaThreadsK6)
legendre_contract_t_mma_kernel(const float* __restrict__ cot, const double2* __restrict__ ab,
                               const double* __restrict__ seed, const double* __restrict__ ct,
                               const int* __restrict__ col_off, const int2* __restrict__ pairs,
                               float* __restrict__ dst, SphereGeom g) {
  constexpr int S = kMmaSamples, RW = 32 * K;
  extern __shared__ __align__(16) float smem[];
  __shared__ uint64_t bar;
  const int tid = threadIdx.x, nt = blockDim.x, lane = tid & 31, warp = tid >> 5, nw = nt >> 5;
  const int LD = K * nt + kLamPad;
  const Pair P(pairs[blockIdx.y], g.lmax, col_off);
  const int b0 = blockIdx.z * S;
  stage(2, [&](int i) { return ab_span(ab, P, smem, i, g.lmax); }, &bar);
  wait_staged(&bar);
  double* lam = reinterpret_cast<double*>(smem + P.ab_words());  // [2][16][LD]: rows 8 q + i
  double* red = lam + 2 * 16 * LD;                                // [2][nw][8][32]

  const int M = g.mmax + 1;
  const double2* ab_s = reinterpret_cast<const double2*>(smem);
  const int chunk0 = blockIdx.x * K * nt;
  const int gq = lane >> 2, tq = lane & 3;
  int it = 0;
  for (int c = 0; c < 2; ++c) {
    const int m = P.m(c);
    if (m < 0) break;
    const double2* abc = ab_s + (c ? P.n0 : 0);
    const int n_l = g.lmax - m + 1;
    // this lane's A operands: column j = gq + 8 h (sample j / 2, part j % 2), ring 4 s + tq
    float ge[8 * K][2], go[8 * K][2];
#pragma unroll
    for (int s = 0; s < 8 * K; ++s) {
      const int rr = chunk0 + warp * RW + 4 * s + tq, rs = g.R - 1 - rr;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int j = gq + 8 * h, b = b0 + (j >> 1);
        float vn = 0.f, vs = 0.f;
        if (rr < g.Rh && b < g.B) {
          const size_t base = (size_t)b * g.R;
          vn = cot[2 * ((base + rr) * M + m) + (j & 1)];
          if (rs > rr) vs = cot[2 * ((base + rs) * M + m) + (j & 1)];
        }
        ge[s][h] = vn + vs;
        go[s][h] = vn - vs;
      }
    }
    double x[K], p0[K], p1[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int r = chunk0 + k * nt + tid;
      x[k] = r < g.Rh ? ct[r] : 0.0;
      p1[k] = r < g.Rh ? seed[(size_t)m * g.Rh + r] : 0.0;  // a ring past the last: lambda = 0
      p0[k] = 0.0;
    }
    auto recur = [&](int t0, int buf) {
      double* lb = lam + buf * 16 * LD;
#pragma unroll
      for (int t = 0; t < 16; ++t) {
        if (t > 0 || t0 > 0) {
          const double2 c2 = abc[t0 + t];
#pragma unroll
          for (int k = 0; k < K; ++k) advance(c2, x[k], p0[k], p1[k]);
        }
        double* rowp = lb + ((t & 1) * 8 + (t >> 1)) * LD;
#pragma unroll
        for (int k = 0; k < K; ++k) rowp[k * nt + tid] = t0 + t < n_l ? p1[k] : 0.0;
      }
    };
    recur(0, it & 1);
    __syncthreads();
    for (int t0 = 0; t0 < n_l; t0 += 16, ++it) {
      const int buf = it & 1;
      if (t0 + 16 < n_l) recur(t0 + 16, buf ^ 1);
      const double* lb = lam + buf * 16 * LD;
      double acc[2][4];  // [parity][4]
#pragma unroll
      for (int q = 0; q < 2; ++q)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[q][e] = 0.0;
#pragma unroll
      for (int s = 0; s < 8 * K; ++s)
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const double bf = lb[(q * 8 + gq) * LD + warp * RW + 4 * s + tq];
          const float* gs = q ? go[s] : ge[s];
          mma1684(acc[q], (double)gs[0], (double)gs[1], bf);
        }
      double* rb = red + buf * nw * 256;
#pragma unroll
      for (int q = 0; q < 2; ++q)
#pragma unroll
        for (int e = 0; e < 4; ++e) rb[(warp * 8 + q * 4 + e) * 32 + lane] = acc[q][e];
      __syncthreads();
      for (int o = tid; o < 256; o += nt) {  // value v of lane ln's fragment, summed in warp order
        const int v = o >> 5, ln = o & 31;
        double sum = 0.0;
        for (int w = 0; w < nw; ++w) sum += rb[(w * 8 + v) * 32 + ln];
        // D^T: row j = ln / 4 + 8 h (sample j / 2, part j % 2), column 2 (ln % 4) + e2 of
        // parity q: l - m = t0 + 2 (2 (ln % 4) + e2) + q
        const int q = v >> 2, h = (v >> 1) & 1, e2 = v & 1;
        const int j = (ln >> 2) + 8 * h, pt = j & 1, b = b0 + (j >> 1);
        const int d = t0 + 2 * (2 * (ln & 3) + e2) + q;
        if (d < n_l && b < g.B && (m > 0 || pt == 0))
          dst[((size_t)blockIdx.x * g.B + b) * g.size + P.co(c) + (m > 0 ? 2 * d + pt : d)] =
              (float)sum;
      }
    }
  }
}

__global__ void chunk_sum_kernel(const float* __restrict__ partial, float* __restrict__ out,
                                 int n, int n_chunks) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int c = 0; c < n_chunks; ++c) s += partial[(size_t)c * n + i];
  out[i] = s;
}

// ---- launches ----------------------------------------------------------------------

// shared-memory bytes: the ab rows of a pair (at most 2 lmax - mmax + 2
// entries), a sample's two alm slots (at most 2 (2 lmax - mmax + 2) + 12
// words), the tensor-core kernels' lambda tiles and K6's warp sums
size_t ab_bytes(const SphereGeom& g) { return 16 * (size_t)(2 * g.lmax - g.mmax + 2 + kAbPad); }
size_t alm_bytes(const SphereGeom& g, int samples) {
  return 4 * (size_t)samples * (2 * (2 * g.lmax - g.mmax + 2) + 12);
}

template <class Kernel, class In, class Out>
int launch(Kernel kernel, dim3 grid, int threads, size_t smem, cudaStream_t s, In in,
           const double2* ab, const double* seed, const double* ct, const int* col_off,
           const int2* pairs, Out out, const SphereGeom& g) {
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<grid, threads, smem, s>>>(in, ab, seed, ct, col_off, pairs, out, g);
  return (int)cudaGetLastError();
}

// the CUDA-core kernels' instance for nb samples a block (1, 2 or 4) and K rings a thread
using K5Fn = decltype(&legendre_contract_kernel<1, 2>);
using K6Fn = decltype(&legendre_contract_t_kernel<1, 2>);
K5Fn k5_instance(int nb, int K) {
  if (nb == 1) return K == 2 ? legendre_contract_kernel<1, 2> : legendre_contract_kernel<1, 4>;
  if (nb == 2) return K == 2 ? legendre_contract_kernel<2, 2> : legendre_contract_kernel<2, 4>;
  return K == 2 ? legendre_contract_kernel<4, 2> : legendre_contract_kernel<4, 4>;
}
K6Fn k6_instance(int nb, int K) {
  if (nb == 1) return K == 2 ? legendre_contract_t_kernel<1, 2> : legendre_contract_t_kernel<1, 4>;
  if (nb == 2) return K == 2 ? legendre_contract_t_kernel<2, 2> : legendre_contract_t_kernel<2, 4>;
  return K == 2 ? legendre_contract_t_kernel<4, 2> : legendre_contract_t_kernel<4, 4>;
}

int samples_per_block(int B) { return B == 1 ? 1 : B == 2 ? 2 : 4; }

// the launch the wrapper chose (ops/cuda_legendre.py launch_config), checked
bool config_ok(const SphereGeom& g, int mma, int K, int threads, int n_chunks, bool transpose) {
  if (g.B < 1 || g.Rh < 1 || threads < 32 || threads % 32) return false;
  if (mma && !transpose)
    return K == 1 && threads == kMmaThreadsK5 && n_chunks == blocks_for(g.Rh, 32);
  if (mma)
    return (K == 1 || K == 2) && threads <= kMmaThreadsK6 &&
           n_chunks == blocks_for(g.Rh, (long long)threads * K);
  return (K == 2 || K == 4) && threads <= kMaxThreads &&
         n_chunks == blocks_for(g.Rh, (long long)threads * K);
}

}  // namespace

// alm (B, size) float32; ab (mmax+1, lmax+1) double2 = (a_{l,m}, b_{l,m});
// seed (mmax+1, Rh) float64; ct (Rh,) float64 cos theta of the northern
// rings; col_off (mmax+1,) int32; pairs (mmax/2+1,) int2; out (B, R, mmax+1)
// float2; the launch: mma (tensor cores), K rings a thread, threads, ring
// chunks
extern "C" int nt_legendre_contract(const void* alm, const void* ab, const void* seed,
                                    const void* ct, const void* col_off, const void* pairs,
                                    void* out, int B, int size, int lmax, int mmax, int R, int Rh,
                                    int mma, int K, int threads, int n_chunks, void* stream) {
  const SphereGeom g{B, size, lmax, mmax, R, Rh};
  if (!config_ok(g, mma, K, threads, n_chunks, false)) return (int)cudaErrorInvalidValue;
  const float* a = (const float*)alm;
  const double2* t = (const double2*)ab;
  const double* sd = (const double*)seed;
  const double* c = (const double*)ct;
  const int* co = (const int*)col_off;
  const int2* pr = (const int2*)pairs;
  float2* o = (float2*)out;
  cudaStream_t s = (cudaStream_t)stream;
  const int n_pairs = mmax / 2 + 1;
  if (mma) {
    const int cw = kMmaThreadsK5 / 32;
    const size_t smem = cw * 8 * (32 + kLamPad) * sizeof(double) +
                        kMmaSamples * 2 * 32 * cw * sizeof(float2);
    return launch(legendre_contract_mma_kernel,
                  dim3(n_chunks, blocks_for(mmax + 1, cw), blocks_for(B, kMmaSamples)), threads,
                  smem, s, a, t, sd, c, co, pr, o, g);
  }
  const int nb = samples_per_block(B);
  return launch(k5_instance(nb, K), dim3(n_chunks, n_pairs, blocks_for(B, nb)), threads,
                ab_bytes(g) + alm_bytes(g, nb), s, a, t, sd, c, co, pr, o, g);
}

// cot (B, R, mmax+1) float2; partial (n_chunks, B, size) float32 scratch
// (unused for one chunk); out (B, size) float32; the rest as above
extern "C" int nt_legendre_contract_t(const void* cot, const void* ab, const void* seed,
                                      const void* ct, const void* col_off, const void* pairs,
                                      void* partial, void* out, int B, int size, int lmax,
                                      int mmax, int R, int Rh, int mma, int K, int threads,
                                      int n_chunks, void* stream) {
  const SphereGeom g{B, size, lmax, mmax, R, Rh};
  if (!config_ok(g, mma, K, threads, n_chunks, true)) return (int)cudaErrorInvalidValue;
  const float* gc = (const float*)cot;
  const double2* t = (const double2*)ab;
  const double* sd = (const double*)seed;
  const double* c = (const double*)ct;
  const int* co = (const int*)col_off;
  const int2* pr = (const int2*)pairs;
  float* dst = n_chunks == 1 ? (float*)out : (float*)partial;
  cudaStream_t s = (cudaStream_t)stream;
  const int n_pairs = mmax / 2 + 1;
  int err;
  if (mma) {
    const size_t smem =
        ab_bytes(g) + (2 * 16 * (size_t)(K * threads + kLamPad) + 2 * threads / 32 * 256) * sizeof(double);
    err = launch(K == 1 ? legendre_contract_t_mma_kernel<1> : legendre_contract_t_mma_kernel<2>,
                 dim3(n_chunks, n_pairs, blocks_for(B, kMmaSamples)), threads, smem, s, gc, t, sd, c,
                 co, pr, dst, g);
  } else {
    const int nb = samples_per_block(B);
    err = launch(k6_instance(nb, K), dim3(n_chunks, n_pairs, blocks_for(B, nb)), threads,
                 ab_bytes(g), s, gc, t, sd, c, co, pr, dst, g);
  }
  if (err || n_chunks == 1) return err;
  const int n = B * size, block = 256;
  chunk_sum_kernel<<<blocks_for(n, block), block, 0, s>>>((const float*)partial, (float*)out, n,
                                                          n_chunks);
  return (int)cudaGetLastError();
}
