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
// What bounds them on the card: operations.  The work is
// Rh (lmax+1)(lmax+2)/2 (l, m, ring) triples (mmax = lmax), each a step of
// the recurrence and 2 B multiply-adds a direction: ~67 M triples at nside
// 256, lmax 512; the bytes are a few MB.  The design:
//
// 1. A thread per (northern ring, m): rings across the threads of a block,
//    m on blockIdx.y, so every thread of a block walks the same
//    l = m..lmax and the coefficient reads c[b, l, m] (K5) and the
//    recurrence coefficients a_{l,m}, b_{l,m} are broadcasts.
// 2. The recurrence runs in float64, seeded by lambda_{m,m}(theta_r) from a
//    (mmax+1, Rh) float64 table built on the host (lambda_00 prod_{k<=m}
//    dfac_k sin theta_r).  In float32, lambda_{m,m} ~ sin^m theta drops
//    below the normal range (1e-38) for m >~ 87 / |ln sin theta|, m ~ 390
//    at sin theta = 0.8, while lambda_{l,m} for larger l grows back to
//    O(0.1): a float32 recurrence loses those modes at nside >= 256.  The
//    contraction is float32 (lambda rounded once a step), the source is
//    built without --use_fast_math (no flushed denormals).
// 3. The hemisphere fold in registers: sums over even and odd l + m are
//    kept apart (the loop is unrolled by two, so the parity is static) and
//    F_north = even + odd, F_south = even - odd.  A batch of B samples is
//    contracted against one lambda (accumulators for up to 4 samples in
//    registers; larger batches take more blocks along blockIdx.z).
// 4. K6 gives the same bits every call: a thread holds 2 rings, a warp
//    reduces its rings by shuffles in a fixed order each l, the 4 warps'
//    sums meet in shared memory every 32 l and are added in a fixed order;
//    the per-chunk sums (256 rings a chunk) are added in chunk order by a
//    second launch, without atomics.

#include <cuda_runtime.h>

namespace {

constexpr int kThreadsContract = 128;  // K5: rings a block
constexpr int kThreadsTranspose = 128;  // K6
constexpr int kRingsPerThread = 2;
constexpr int kChunk = kThreadsTranspose * kRingsPerThread;  // K6: rings a block
constexpr int kWarps = kThreadsTranspose / 32;
constexpr int kTileL = 32;  // K6: l-steps between two block reductions

struct SphereGeom {
  int B, size, lmax, mmax, R, Rh;
};

int blocks_for(long long n, int per_block) { return (int)((n + per_block - 1) / per_block); }

template <int NB>
__global__ void __launch_bounds__(kThreadsContract)
legendre_contract_kernel(const float* __restrict__ alm, const double2* __restrict__ ab,
                         const double* __restrict__ seed, const double* __restrict__ ct,
                         const int* __restrict__ col_off, float2* __restrict__ out,
                         SphereGeom g) {
  const int r = blockIdx.x * kThreadsContract + threadIdx.x;
  const int m = blockIdx.y;
  const int b0 = blockIdx.z * NB;
  if (r >= g.Rh) return;
  const int M = g.mmax + 1;
  const bool sine = m > 0;
  const int step = sine ? 2 : 1;  // the packed stride along l
  const double2* abm = ab + (size_t)m * (g.lmax + 1);
  const float* a = alm + col_off[m];
  const double x = ct[r];
  double p1 = seed[(size_t)m * g.Rh + r];
  double p0 = 0.0;

  float ec[NB], es[NB], oc[NB], os[NB];
#pragma unroll
  for (int b = 0; b < NB; ++b) ec[b] = es[b] = oc[b] = os[b] = 0.f;

  // l = m: lambda_{m,m} itself, even parity
  {
    const float lam = (float)p1;
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      if (b0 + b >= g.B) continue;
      const float* ab_ = a + (size_t)(b0 + b) * g.size;
      ec[b] = lam * ab_[0];
      if (sine) es[b] = lam * ab_[1];
    }
  }
  for (int l = m + 1; l <= g.lmax; l += 2) {
    {  // odd l + m
      const double2 c = abm[l];
      const double pn = c.x * x * p1 - c.y * p0;
      p0 = p1;
      p1 = pn;
      const float lam = (float)p1;
      const int off = step * (l - m);
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        if (b0 + b >= g.B) continue;
        const float* ab_ = a + (size_t)(b0 + b) * g.size + off;
        oc[b] = fmaf(lam, ab_[0], oc[b]);
        if (sine) os[b] = fmaf(lam, ab_[1], os[b]);
      }
    }
    if (l + 1 > g.lmax) break;
    {  // even l + m
      const double2 c = abm[l + 1];
      const double pn = c.x * x * p1 - c.y * p0;
      p0 = p1;
      p1 = pn;
      const float lam = (float)p1;
      const int off = step * (l + 1 - m);
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        if (b0 + b >= g.B) continue;
        const float* ab_ = a + (size_t)(b0 + b) * g.size + off;
        ec[b] = fmaf(lam, ab_[0], ec[b]);
        if (sine) es[b] = fmaf(lam, ab_[1], es[b]);
      }
    }
  }
  const int rs = g.R - 1 - r;
#pragma unroll
  for (int b = 0; b < NB; ++b) {
    if (b0 + b >= g.B) continue;
    const size_t row = (size_t)(b0 + b) * g.R;
    out[(row + r) * M + m] = make_float2(ec[b] + oc[b], es[b] + os[b]);
    if (rs > r) out[(row + rs) * M + m] = make_float2(ec[b] - oc[b], es[b] - os[b]);
  }
}

// dst: the per-chunk sums (n_chunks, B, size), or the result (B, size)
// itself when there is one chunk
template <int NB>
__global__ void __launch_bounds__(kThreadsTranspose)
legendre_contract_t_kernel(const float2* __restrict__ cot, const double2* __restrict__ ab,
                           const double* __restrict__ seed, const double* __restrict__ ct,
                           const int* __restrict__ col_off, float* __restrict__ dst,
                           SphereGeom g) {
  __shared__ float red[kWarps][kTileL][2 * NB];
  const int chunk = blockIdx.x, m = blockIdx.y, b0 = blockIdx.z * NB;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int M = g.mmax + 1;
  const double2* abm = ab + (size_t)m * (g.lmax + 1);

  double x[kRingsPerThread], p0[kRingsPerThread], p1[kRingsPerThread];
  float2 ev[kRingsPerThread][NB], od[kRingsPerThread][NB];  // G_north +- G_south
#pragma unroll
  for (int k = 0; k < kRingsPerThread; ++k) {
    const int r = chunk * kChunk + k * kThreadsTranspose + tid;
    const bool ring = r < g.Rh;
    x[k] = ring ? ct[r] : 0.0;
    p1[k] = ring ? seed[(size_t)m * g.Rh + r] : 0.0;  // a ring past the last: lambda = 0
    p0[k] = 0.0;
    const int rs = g.R - 1 - r;
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      float2 n = make_float2(0.f, 0.f), s = make_float2(0.f, 0.f);
      if (ring && b0 + b < g.B) {
        const size_t row = (size_t)(b0 + b) * g.R;
        n = cot[(row + r) * M + m];
        if (rs > r) s = cot[(row + rs) * M + m];
      }
      ev[k][b] = make_float2(n.x + s.x, n.y + s.y);
      od[k][b] = make_float2(n.x - s.x, n.y - s.y);
    }
  }

  const int n_l = g.lmax - m + 1;
  for (int t0 = 0; t0 < n_l; t0 += kTileL) {
    const int tn = min(kTileL, n_l - t0);
    for (int t = 0; t < tn; ++t) {
      const int l = m + t0 + t;
      if (l > m) {
        const double2 c = abm[l];
#pragma unroll
        for (int k = 0; k < kRingsPerThread; ++k) {
          const double pn = c.x * x[k] * p1[k] - c.y * p0[k];
          p0[k] = p1[k];
          p1[k] = pn;
        }
      }
      const bool even = ((l - m) & 1) == 0;
      float vc[NB], vs[NB];
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        vc[b] = 0.f;
        vs[b] = 0.f;
#pragma unroll
        for (int k = 0; k < kRingsPerThread; ++k) {
          const float lam = (float)p1[k];
          const float2 f = even ? ev[k][b] : od[k][b];
          vc[b] = fmaf(lam, f.x, vc[b]);
          vs[b] = fmaf(lam, f.y, vs[b]);
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
          vc[b] += __shfl_xor_sync(0xffffffffu, vc[b], o);
          vs[b] += __shfl_xor_sync(0xffffffffu, vs[b], o);
        }
      }
      if (lane == 0) {
#pragma unroll
        for (int b = 0; b < NB; ++b) {
          red[warp][t][2 * b] = vc[b];
          red[warp][t][2 * b + 1] = vs[b];
        }
      }
    }
    __syncthreads();
    for (int e = tid; e < tn * 2 * NB; e += kThreadsTranspose) {
      const int t = e / (2 * NB), q = e - t * 2 * NB, b = q >> 1, part = q & 1;
      if (b0 + b >= g.B || (part == 1 && m == 0)) continue;
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) s += red[w][t][q];
      const int l = m + t0 + t;
      const int idx = col_off[m] + (m == 0 ? l : 2 * (l - m) + part);
      dst[((size_t)chunk * g.B + b0 + b) * g.size + idx] = s;
    }
    __syncthreads();
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

template <int NB>
void launch_contract(const float* alm, const double2* ab, const double* seed, const double* ct,
                     const int* col_off, float2* out, const SphereGeom& g, cudaStream_t s) {
  dim3 grid(blocks_for(g.Rh, kThreadsContract), g.mmax + 1, blocks_for(g.B, NB));
  legendre_contract_kernel<NB><<<grid, kThreadsContract, 0, s>>>(alm, ab, seed, ct, col_off,
                                                                 out, g);
}

template <int NB>
void launch_transpose(const float2* cot, const double2* ab, const double* seed, const double* ct,
                      const int* col_off, float* dst, const SphereGeom& g, int n_chunks,
                      cudaStream_t s) {
  dim3 grid(n_chunks, g.mmax + 1, blocks_for(g.B, NB));
  legendre_contract_t_kernel<NB><<<grid, kThreadsTranspose, 0, s>>>(cot, ab, seed, ct, col_off,
                                                                    dst, g);
}

}  // namespace

// alm (B, size) float32; ab (mmax+1, lmax+1) double2 = (a_{l,m}, b_{l,m});
// seed (mmax+1, Rh) float64; ct (Rh,) float64 cos theta of the northern
// rings; col_off (mmax+1,) int32; out (B, R, mmax+1) float2
extern "C" int nt_legendre_contract(const void* alm, const void* ab, const void* seed,
                                    const void* ct, const void* col_off, void* out, int B,
                                    int size, int lmax, int mmax, int R, int Rh, void* stream) {
  const SphereGeom g{B, size, lmax, mmax, R, Rh};
  const float* a = (const float*)alm;
  const double2* t = (const double2*)ab;
  const double* sd = (const double*)seed;
  const double* c = (const double*)ct;
  const int* co = (const int*)col_off;
  float2* o = (float2*)out;
  cudaStream_t s = (cudaStream_t)stream;
  if (B == 1) launch_contract<1>(a, t, sd, c, co, o, g, s);
  else if (B == 2) launch_contract<2>(a, t, sd, c, co, o, g, s);
  else launch_contract<4>(a, t, sd, c, co, o, g, s);
  return (int)cudaGetLastError();
}

// cot (B, R, mmax+1) float2; partial (n_chunks, B, size) float32 scratch
// (unused for one chunk); out (B, size) float32
extern "C" int nt_legendre_contract_t(const void* cot, const void* ab, const void* seed,
                                      const void* ct, const void* col_off, void* partial,
                                      void* out, int B, int size, int lmax, int mmax, int R,
                                      int Rh, int n_chunks, void* stream) {
  if (n_chunks != blocks_for(Rh, kChunk)) return (int)cudaErrorInvalidValue;
  const SphereGeom g{B, size, lmax, mmax, R, Rh};
  const float2* gc = (const float2*)cot;
  const double2* t = (const double2*)ab;
  const double* sd = (const double*)seed;
  const double* c = (const double*)ct;
  const int* co = (const int*)col_off;
  float* dst = n_chunks == 1 ? (float*)out : (float*)partial;
  cudaStream_t s = (cudaStream_t)stream;
  if (B == 1) launch_transpose<1>(gc, t, sd, c, co, dst, g, n_chunks, s);
  else if (B == 2) launch_transpose<2>(gc, t, sd, c, co, dst, g, n_chunks, s);
  else launch_transpose<4>(gc, t, sd, c, co, dst, g, n_chunks, s);
  int err = (int)cudaGetLastError();
  if (err || n_chunks == 1) return err;
  const int n = B * size, threads = 256;
  chunk_sum_kernel<<<blocks_for(n, threads), threads, 0, s>>>((const float*)partial, (float*)out,
                                                               n, n_chunks);
  return (int)cudaGetLastError();
}
