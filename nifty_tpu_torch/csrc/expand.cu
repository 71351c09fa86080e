// K1 and K2 of the exact-spectrum correlated field: the expansion of a
// per-unique-|k| table straight onto the full harmonic grid, and its exact
// adjoint from the full-grid cotangent straight back to the table.
//
// Replaces nifty_tpu/ops/pallas_expand.py:forward_fn (K1) and :transpose_fn
// (K2) together with the layout glue around them: the rfp2 unpack and fold
// (nifty_tpu/ops/mode_expand.py) and the mirror unfold of the core onto the
// full grid (nifty_tpu/models/correlated_field.py:_mirror_unfold).  On the
// TPU the kernels were Clos-routed lane-shuffle networks writing the packed
// table, because an XLA:TPU gather costs ~7 ns per index; the layout ops
// were separate XLA passes.  Here the kernels compute the composite:
//
//   K1: out[i0, i1, i2][, b] = tab[idx[pos(x0, x1, x2)]][, b],
//       x_a = i_a if i_a < c_a else n_a - i_a on each axis (c_a = n_a//2+1
//       on a mirrored axis, c_a = n_a on one that is not), and pos() the
//       packed position of the core point: rfp2 (a square core of odd side
//       H = 2m+1 whose upper triangle is packed into (m+1, H)) with
//       a = min(x1, x2), b = max(x1, x2): R[b-m, a-m-1] if a > m else
//       R[a, b]; a flat layout at x0*c1*c2 + x1*c2 + x2.
//   K2: tab_cot[u][, b] = the sum of cot over the full-grid points whose
//       core index is u.
//
// What bounds them on the card: device-memory bytes.  Both move the
// full-grid array once (67 MB at 4096^2, B = 1), the packed int32 index
// once (8.4 MB) and the table once (4.8 MB): 80.3 MB, 24 us at 3.35 TB/s.
// They do no arithmetic worth counting (K2 one add per grid point), so
// tensor cores buy nothing.  The design answers the bytes, and the sectors:
//
// 1. Each packed point is looked up once.  A table read lands on its own
//    32-byte sector (neighbouring grid points lie in distant |k| bins), so
//    a gather per grid point (16.8M at 4096^2) costs 8 times the sectors
//    of a gather per packed point (2.1M); a first design that did so took
//    0.195 ms at 4096^2.  K1 works on the packed points and writes each
//    value to its <= 8 full-grid images (2 mirrors on each of two axes,
//    times the transposition of rfp2), K2 sums those images in a fixed
//    order.  The full-grid index is never stored.
// 2. rfp2 goes by 32 x 32 tiles (I, J), I <= J, of the core, a block of
//    32 x 8 threads each.  K1 reads the tile's packed indices coalesced
//    (packed rows a <= m along b, rows a > m along a) into shared memory
//    and writes the images of tile (I, J) and of its transpose (J, I) in
//    runs of 4 grid points a thread, one 16-byte store each at B = 1 when
//    the row pitch is a multiple of 4 (a warp writes four rows of 128
//    bytes).  A mirrored run holds the images of core columns 32J + 1 ..
//    32J + 32, not 32J .. 32J + 31, so it starts on a multiple of 4 (of 32
//    when n is one) as a direct run does; the shared tile holds the row and
//    the column after the tile for it (33 x 33 values).  K2 loads the
//    mirror-folded tiles (I, J) and (J, I) into shared memory with coalesced row reads,
//    adds each point to its transpose there and writes the packed rows
//    coalesced.  Flat layouts (no transposition) take a thread per core
//    point.  Shared-memory rows are padded to 33, so the transposed reads
//    are free of bank conflicts.
// 3. No runtime division: blocks map to tiles and rows through blockIdx,
//    and B % 4 == 0 (one float4 per point), B % 2 == 0 (one float2) or
//    neither, K1's runs of 4 points or 1, and a row range's tile map are
//    template parameters.
// 4. Occupancy and stores.  Unbounded, the tile kernels took 64 registers a
//    thread, 4 blocks an SM; bounded to 6 blocks (40 registers, no spills)
//    the K2 fold took 0.058 against 0.074 ms at 4096^2, B = 1 (8 blocks
//    spilled and were slower).  K1 writing rows of 32 scalar stores (a
//    mirrored row backwards and one sector off) took 0.051 ms; the 16-byte
//    runs took 0.049 at 6 blocks an SM (spilling), 0.043 at 5 (48
//    registers, no spills) and 0.042 at 4; at B = 4 0.137, 0.120 and 0.130
//    against 0.143: K1 takes 5.  Streaming stores in K1 took 0.141
//    against 0.167 ms at B = 4 and changed nothing at B = 1.  An L2
//    access-policy window pinning the table changed K1 by under 5 % and
//    is not used.  (bench/expand_bench.py, each comparison in one call.)
// 5. K2 is deterministic and uses no global atomics (CG runs repeat
//    exactly).  Launch 1 folds the grid onto the packed points as above;
//    launch 2 is the segment sum over the folded packed array (8.4 MB at
//    4096^2, in L2) through the CSR form of the index that the host builds
//    once (the index's stable argsort and the bins' offsets): a thread per
//    bin of <= 32 members, a warp per larger bin, each in a fixed order,
//    BC sample columns a read.
//    (Writing the fold in CSR order instead, so that the sum reads each bin
//    contiguous, made the sum 3x faster and the fold's scattered writes
//    slower by more: 0.074 against 0.070 ms at 4096^2, B = 1, and 0.36
//    against 0.19 at B = 4.)

// 6. Row ranges (K1r, K2r: the amplitude of a row-sharded field).  The
//    geometry names a range [r_lo, r_lo + r_n) of the full grid's leading
//    field axis (axis 1 of a 2-D grid, axis 0 of a 3-D one); only its
//    images are written (K1r, at row - r_lo) or read (K2r).  The core rows
//    whose images the range holds are one interval (a row y >= c is core
//    row n - y, and a range's two halves meet: cuda_expand.core_rows), and
//    the host passes it as the launch rows [k_lo, k_lo + k_n): rfp2 tile
//    rows, flat core rows.  So the work follows the rows:
//    - K1r launches T x k_n blocks, each the tile {K, X} of its launch row
//      K and tile row X (tile_of; those with X a launch row below K return
//      at once), and loads and stores as K1: at 4096^2 over 8 ranks 45 %
//      of the tiles, over 4 74 %.
//    - K2r folds the same tiles and sums, through the range's own CSR
//      (cuda_expand.ExpandRows: the packed points with an image in the
//      range, in the index's CSR order, and the bins they touch; built once
//      a range from the index's CSR, kept on the index), only those points,
//      after one memset of the table (every other bin 0; the caller sums
//      the parts over the ranks).  A range with an image of >= 90 % of the
//      packed points (2 ranks) takes K2's launches with the range in the
//      geometry instead: every tile folded, every bin summed, no memset.
//    What bounds them is not the bytes but the L2's 32-byte sectors: a
//    table gather (K1r) or a folded gather (K2r's sum) costs a sector of
//    its own, and the kernels' parts follow each other at ~90-110 G sectors
//    a second (the phase cut: K1 at 4096^2, B = 1, 0.0236 ms of loads (2.6M
//    sectors) and 0.0237 of stores (2.1M) add up to its 0.0423; K2r's
//    segment sum takes ~11 ns a member).  Unrolling the loads (an index
//    staged in shared memory, the mirror sums predicated) bought up to 10 %
//    on the full grid and lost on ranges; a fold into CSR order moved the
//    cost from the sum to the fold (note 5).  B = 2 (the draws' batch) takes
//    8-byte vectors (BC = 2): the scalar path wrote each grid sector twice.
//    (bench/sharded_kernels_bench.py; PERF.md section 6.)

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;  // the flat layouts' kernels
constexpr int kTile = 32;      // rfp2 tiles: 32 x 32 core points
constexpr int kTileRows = 8;   // rfp2 tiles: a block is 32 x 8 threads
constexpr int kMinBlocks = 6;  // K2's rfp2 fold: 6 blocks an SM, <= 40 registers a thread
constexpr int kMinBlocksExpand = 5;  // K1's rfp2 tiles: 5 blocks an SM, <= 48 registers
// K1r's at B = 1: 4 blocks (60 registers; at 5 the tile map spilled 12 bytes,
// 4-5 % slower over 2-8 ranks; at B = 2 and 4, 5 blocks stay 2-5 % faster)
constexpr int kMinBlocksRange = 4;

// full grid (n0, n1, n2), core (c0, c1, c2), m = H // 2 for rfp2 (axes 1, 2);
// the rows [r_lo, r_lo + r_n) of axis r_ax (0 or 1) that the grid side holds;
// for a range (k_n > 0; note 6) its launch rows [k_lo, k_lo + k_n) on that
// axis: rfp2 tile rows, flat core rows
struct Geom {
  int n0, n1, n2, c0, c1, c2, m, r_ax, r_lo, r_n, k_lo, k_n;
};

// The rfp2 tile (I, J), I <= J, of this block, or false for none.  The full
// grid: (J, I) = (blockIdx.x, blockIdx.y), none below the diagonal.  A range:
// blockIdx.y walks the tile rows K that meet the range's core rows,
// blockIdx.x every tile row X; the block takes the tile {K, X} ordered, none
// when X is a tile row of the range below K (launch row X takes it).
template <bool kRange>
__device__ __forceinline__ bool tile_of(const Geom& g, int& I, int& J) {
  if constexpr (kRange) {
    const int K = g.k_lo + blockIdx.y, X = blockIdx.x;
    if (X < K && X >= g.k_lo) return false;
    I = min(K, X);
    J = max(K, X);
  } else {
    I = blockIdx.y;
    J = blockIdx.x;
  }
  return I <= J;
}

// BC consecutive floats: read through the read-only cache, or written
// (plainly, or streaming: evict first), as one vector when BC is 2 or 4.
template <int BC>
__device__ __forceinline__ void load_vec(const float* __restrict__ p, float* v) {
  if constexpr (BC == 4) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  } else if constexpr (BC == 2) {
    const float2 q = __ldg(reinterpret_cast<const float2*>(p));
    v[0] = q.x; v[1] = q.y;
  } else {
    v[0] = __ldg(p);
  }
}

template <int BC>
__device__ __forceinline__ void store_vec(float* __restrict__ p, const float* v) {
  if constexpr (BC == 4) *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  else if constexpr (BC == 2) *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  else p[0] = v[0];
}

template <int BC>
__device__ __forceinline__ void store_vec_cs(float* __restrict__ p, const float* v) {
  if constexpr (BC == 4) __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
  else if constexpr (BC == 2) __stcs(reinterpret_cast<float2*>(p), make_float2(v[0], v[1]));
  else __stcs(p, v[0]);
}

// Row x of axis `ax` as a row of the range (its index less r_lo), or -1
// when the range does not hold it.
__device__ __forceinline__ int local_row(const Geom& g, int ax, int x) {
  if (ax != g.r_ax) return x;
  x -= g.r_lo;
  return (unsigned)x < (unsigned)g.r_n ? x : -1;
}

// The <= 2 full-grid images of core point x on an axis: x, and n - x when
// 1 <= x <= n - c (a mirrored axis' upper half).
__device__ __forceinline__ int images(int x, int c, int n, int* at) {
  at[0] = x;
  at[1] = n - x;
  return (x >= 1 && x <= n - c) ? 2 : 1;
}

// The images of core point x on axis `ax` that the range holds, as rows of
// it (all of them on an axis that is not the range's).
// Constant indices only, so `at` stays in registers.
__device__ __forceinline__ int local_images(const Geom& g, int ax, int x, int c, int n, int* at) {
  const int k = images(x, c, n, at);
  const int y0 = local_row(g, ax, at[0]);
  const int y1 = k > 1 ? local_row(g, ax, at[1]) : -1;
  at[0] = y0 >= 0 ? y0 : y1;
  at[1] = y1;
  return (y0 >= 0) + (y1 >= 0);
}

// Stores BC sample columns of value v at grid point (i1, i2) of slab i0,
// marked streaming (evict first): the grid is written once and read by the
// next kernel, the table and the index are read again.
template <int BC>
__device__ __forceinline__ void store_point(float* __restrict__ out, const Geom& g, int i0, int i1,
                                            int i2, int B, int b0, const float* v) {
  // (i0, i1) are rows of the range; axis 1 holds r_n rows when it is the range's
  const int e1 = g.r_ax == 1 ? g.r_n : g.n1;
  store_vec_cs<BC>(out + (((long long)i0 * e1 + i1) * g.n2 + i2) * B + b0, v);
}

// Stores points k in [lo, hi) of the run of V grid points that starts at
// (i1, j0); a whole run of V = 4 (B = 1, j0 and the row pitch multiples of
// 4) as one 16-byte streaming store.
template <int BC, int V>
__device__ __forceinline__ void store_run(float* __restrict__ out, const Geom& g, int i1, int j0,
                                          int B, int b0, float (&v)[V][BC], int lo, int hi) {
  if constexpr (V == 4) {
    if (lo == 0 && hi == V) {
      float* dst = out + (long long)i1 * g.n2 + j0;
      __stcs(reinterpret_cast<float4*>(dst), make_float4(v[0][0], v[1][0], v[2][0], v[3][0]));
      return;
    }
  }
#pragma unroll
  for (int k = 0; k < V; ++k)  // unrolled, so v stays in registers
    if (k >= lo && k < hi) store_point<BC>(out, g, 0, i1, j0 + k, B, b0, v[k]);
}

// Loads BC sample columns of table row p.
template <int BC>
__device__ __forceinline__ void load_row(const float* __restrict__ tab, int p, int B, int b0,
                                         float* v) {
  load_vec<BC>(tab + (long long)p * B + b0, v);
}

constexpr int kEdge = kTile + 1;  // K1's shared tile: one row and one column more

// K1: writes core row a of a tile whose first core column is cb to grid
// rows a and n1 - a; the row's values are S[c * sc] (sample column e at
// S + e * kEdge^2), c the tile's column.  Points V q .. V q + V - 1 of two
// runs: the direct columns cb + V q + k (those < c2), and the mirror images
// of core columns cb + 32 - V q - k (those <= n2 - c2) at grid columns
// n2 - cb - 32 + V q + k.  Taking the mirror of columns cb + 1 .. cb + 32,
// not cb .. cb + 31, puts both runs on multiples of V when n2 is one.
template <int BC, int V>
__device__ __forceinline__ void expand_row(float* __restrict__ out, const Geom& g, int B, int b0,
                                           const float* S, int sc, int a, int cb, int q) {
  if (a >= g.c1) return;
  int rows[2];
  const int nr = local_images(g, 1, a, g.c1, g.n1, rows);  // the images in the range
  if (nr == 0) return;
  const int c0 = V * q;
  float v[V][BC];
  const int hi = min(V, g.c2 - cb - c0);  // direct: k < hi
  if (hi > 0) {
#pragma unroll
    for (int k = 0; k < V; ++k)
#pragma unroll
      for (int e = 0; e < BC; ++e) v[k][e] = S[e * kEdge * kEdge + (c0 + k) * sc];
#pragma unroll
    for (int u = 0; u < 2; ++u)
      if (u < nr) store_run<BC, V>(out, g, rows[u], cb + c0, B, b0, v, 0, hi);
  }
  const int lo = max(0, cb + kTile - c0 - (g.n2 - g.c2));  // mirror: k >= lo
  if (lo < V) {
#pragma unroll
    for (int k = 0; k < V; ++k)
#pragma unroll
      for (int e = 0; e < BC; ++e) v[k][e] = S[e * kEdge * kEdge + (kTile - c0 - k) * sc];
#pragma unroll
    for (int u = 0; u < 2; ++u)
      if (u < nr) store_run<BC, V>(out, g, rows[u], g.n2 - cb - kTile + c0, B, b0, v, lo, V);
  }
}

// K1 for rfp2: tile (I, J) = (blockIdx.y, blockIdx.x), I <= J, of the (H, H)
// core.  S[r][c] holds the core value at (32I + r, 32J + c), r, c <= 32:
// the tile, and the row and column after it, which the mirror runs of the
// tile's transpose and of the tile take.  Each value is looked up once
// (packed rows a <= m along b, rows a > m along a: both coalesced); the
// block then writes the <= 4 mirror images of tile (I, J) and, for I < J,
// of its transpose (J, I): each thread V consecutive points of one grid row
// (V = 4 at B = 1 when n2 % 4 == 0: 16-byte stores, a warp four aligned
// 128-byte rows; else V = 1, a warp one row).  kRange: only the tiles that
// meet a range's core rows (tile_of).
template <int BC, int V, bool kRange>
__global__ void __launch_bounds__(kTile * kTileRows,
                                  kRange && V == 4 ? kMinBlocksRange : kMinBlocksExpand)
expand_rfp2_kernel(const float* __restrict__ tab, const int* __restrict__ idx,
                   float* __restrict__ out, Geom g, int B) {
  int I, J;
  if (!tile_of<kRange>(g, I, J)) return;
  constexpr int kBlock = kTile * kTileRows, kRuns = kTile / V;
  __shared__ float S[BC][kEdge][kEdge];
  const int H = g.c2, m = g.m;
  const int t = threadIdx.y * kTile + threadIdx.x;
  for (int b0 = 0; b0 < B; b0 += BC) {
    float v[BC];
    for (int e = t; e < kEdge * kEdge; e += kBlock) {  // packed rows a <= m, lanes along b
      const int r = e / kEdge, c = e % kEdge;
      const int x = kTile * I + r, y = kTile * J + c;
      const int a = min(x, y), b = max(x, y);
      if (a <= m && b < H) {
        load_row<BC>(tab, __ldg(idx + a * H + b), B, b0, v);
#pragma unroll
        for (int k = 0; k < BC; ++k) S[k][r][c] = v[k];
      }
    }
    for (int e = t; e < kEdge * kEdge; e += kBlock) {  // packed rows a > m, lanes along a
      const int c = e / kEdge, r = e % kEdge;
      const int x = kTile * I + r, y = kTile * J + c;
      const int a = min(x, y), b = max(x, y);
      if (a > m && b < H) {
        load_row<BC>(tab, __ldg(idx + (b - m) * H + (a - m - 1)), B, b0, v);
#pragma unroll
        for (int k = 0; k < BC; ++k) S[k][r][c] = v[k];
      }
    }
    __syncthreads();
    const int q = t % kRuns;
#pragma unroll 1
    for (int p = 0; p < (I < J ? 2 : 1); ++p)  // tile (I, J): S's rows; tile (J, I): its columns
      for (int r = t / kRuns; r < kTile; r += kBlock / kRuns)
        expand_row<BC, V>(out, g, B, b0, p ? &S[0][0][r] : &S[0][r][0], p ? kEdge : 1,
                          kTile * (p ? J : I) + r, kTile * (p ? I : J), q);
    __syncthreads();
  }
}

// The core rows (x0, x1) of a flat kernel's block; kRange: the range's
// axis walks its launch rows only.
template <bool kRange>
__device__ __forceinline__ void flat_rows(const Geom& g, int& x0, int& x1) {
  x0 = blockIdx.z;
  x1 = blockIdx.y;
  if constexpr (kRange) {
    if (g.r_ax == 0) x0 += g.k_lo;
    else x1 += g.k_lo;
  }
}

// K1 for a flat layout: a thread per core point (x0, x1, x2), its index
// read coalesced along x2, its value written to its <= 8 mirror images.
template <int BC, bool kRange>
__global__ void __launch_bounds__(kThreads)
expand_flat_kernel(const float* __restrict__ tab, const int* __restrict__ idx,
                   float* __restrict__ out, Geom g, int B) {
  int x0, x1;
  flat_rows<kRange>(g, x0, x1);
  const int x2 = blockIdx.x * kThreads + threadIdx.x;
  if (x2 >= g.c2) return;
  int s[2], r[2], c[2];
  const int ns = local_images(g, 0, x0, g.c0, g.n0, s), nr = local_images(g, 1, x1, g.c1, g.n1, r),
            nc = images(x2, g.c2, g.n2, c);
  if (ns == 0 || nr == 0) return;
  const int p = __ldg(idx + (x0 * g.c1 + x1) * g.c2 + x2);
  for (int b0 = 0; b0 < B; b0 += BC) {
    float v[BC];
    load_row<BC>(tab, p, B, b0, v);
    for (int w = 0; w < ns; ++w)
      for (int u = 0; u < nr; ++u)
        for (int q = 0; q < nc; ++q) store_point<BC>(out, g, s[w], r[u], c[q], B, b0, v);
  }
}

// The mirror fold of core point (x1, x2) of a 2-D grid at sample columns
// b0 .. b0+BC-1: its <= 4 images summed in a fixed order.
template <int BC>
__device__ __forceinline__ void mirror_sum(const float* __restrict__ cot, const Geom& g,
                                           int x1, int x2, int B, int b0, float* acc) {
  int r[2], c[2];
  const int nr = local_images(g, 1, x1, g.c1, g.n1, r), nc = images(x2, g.c2, g.n2, c);
#pragma unroll
  for (int k = 0; k < BC; ++k) acc[k] = 0.f;
  for (int u = 0; u < nr; ++u)
    for (int v = 0; v < nc; ++v) {
      float q[BC];
      load_vec<BC>(cot + ((long long)r[u] * g.n2 + c[v]) * B + b0, q);
#pragma unroll
      for (int k = 0; k < BC; ++k) acc[k] += q[k];
    }
}

// K2, launch 1 for rfp2: tile (I, J), I <= J, of the (H, H) core (tile_of);
// BC sample columns at a time (4 when B % 4 == 0, 2 when B % 2 == 0, else 1).
template <int BC, bool kRange>
__global__ void __launch_bounds__(kTile * kTileRows, kMinBlocks)
collapse_fold_rfp2_kernel(const float* __restrict__ cot, float* __restrict__ folded, Geom g,
                          int B) {
  int I, J;
  if (!tile_of<kRange>(g, I, J)) return;
  __shared__ float A[BC][kTile][kTile + 1];   // A[r][c]  = C(32I + r, 32J + c)
  __shared__ float At[BC][kTile][kTile + 1];  // At[r][c] = C(32J + r, 32I + c)
  const int H = g.c2, m = g.m;
  const int tx = threadIdx.x, ty = threadIdx.y;
  for (int b0 = 0; b0 < B; b0 += BC) {
    for (int r = ty; r < kTile; r += kTileRows) {
      float acc[BC];
      int a = kTile * I + r, b = kTile * J + tx;
      if (a < H && b < H) {
        mirror_sum<BC>(cot, g, a, b, B, b0, acc);
#pragma unroll
        for (int k = 0; k < BC; ++k) A[k][r][tx] = acc[k];
      }
      a = kTile * J + r, b = kTile * I + tx;
      if (a < H && b < H) {
        mirror_sum<BC>(cot, g, a, b, B, b0, acc);
#pragma unroll
        for (int k = 0; k < BC; ++k) At[k][r][tx] = acc[k];
      }
    }
    __syncthreads();
    // rows a <= m: R[a, b], lanes along b
    for (int r = ty; r < kTile; r += kTileRows) {
      const int a = kTile * I + r, b = kTile * J + tx;
      if (a <= m && b < H && a <= b) {
        float* dst = folded + ((long long)a * H + b) * B + b0;
        float v[BC];
#pragma unroll
        for (int k = 0; k < BC; ++k) v[k] = A[k][r][tx] + (a < b ? At[k][tx][r] : 0.f);
        store_vec<BC>(dst, v);
      }
    }
    // rows a > m: R[b - m, a - m - 1], lanes along a
    for (int c = ty; c < kTile; c += kTileRows) {
      const int a = kTile * I + tx, b = kTile * J + c;
      if (a > m && b < H && a <= b) {
        float* dst = folded + ((long long)(b - m) * H + (a - m - 1)) * B + b0;
        float v[BC];
#pragma unroll
        for (int k = 0; k < BC; ++k) v[k] = A[k][tx][c] + (a < b ? At[k][c][tx] : 0.f);
        store_vec<BC>(dst, v);
      }
    }
    __syncthreads();
  }
}

// K2, launch 1 for a flat layout: a thread per core point (x0, x1, x2) and
// BC sample columns; its <= 8 images summed in a fixed order.
template <int BC, bool kRange>
__global__ void __launch_bounds__(kThreads)
collapse_fold_flat_kernel(const float* __restrict__ cot, float* __restrict__ folded, Geom g,
                          int B) {
  int x0, x1;
  flat_rows<kRange>(g, x0, x1);
  const int x2 = blockIdx.x * kThreads + threadIdx.x;
  if (x2 >= g.c2) return;
  int s[2], r[2], c[2];
  const int ns = local_images(g, 0, x0, g.c0, g.n0, s), nr = local_images(g, 1, x1, g.c1, g.n1, r),
            nc = images(x2, g.c2, g.n2, c);
  const int e1 = g.r_ax == 1 ? g.r_n : g.n1;  // the cotangent's axis-1 extent
  float* dst = folded + (((long long)x0 * g.c1 + x1) * g.c2 + x2) * B;
  for (int b0 = 0; b0 < B; b0 += BC) {
    float acc[BC];
#pragma unroll
    for (int k = 0; k < BC; ++k) acc[k] = 0.f;
    for (int w = 0; w < ns; ++w)
      for (int u = 0; u < nr; ++u)
        for (int v = 0; v < nc; ++v) {
          float q[BC];
          load_vec<BC>(cot + (((long long)s[w] * e1 + r[u]) * g.n2 + c[v]) * B + b0, q);
#pragma unroll
          for (int k = 0; k < BC; ++k) acc[k] += q[k];
        }
    store_vec<BC>(dst + b0, acc);
  }
}

// K2, launch 2: one thread per bin of a CSR of at most `large` members, BC
// sample columns at a time, the bin's members summed in CSR order.  Bin s
// of the CSR is table row bins[s] (K2r: the bins a range touches), or s
// when bins is null (K2: the whole index's CSR, every bin).
template <int BC>
__global__ void segsum_small_kernel(const float* __restrict__ folded, const int* __restrict__ perm,
                                    const int* __restrict__ offsets, const int* __restrict__ bins,
                                    int n_bins, int large, float* __restrict__ out, int B) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= n_bins) return;
  const int lo = __ldg(offsets + s), hi = __ldg(offsets + s + 1);
  if (hi - lo > large) return;
  float* dst = out + (long long)(bins ? __ldg(bins + s) : s) * B;
  for (int b0 = 0; b0 < B; b0 += BC) {
    float acc[BC];
#pragma unroll
    for (int k = 0; k < BC; ++k) acc[k] = 0.f;
    for (int e = lo; e < hi; ++e) {
      float v[BC];
      load_vec<BC>(folded + (long long)__ldg(perm + e) * B + b0, v);
#pragma unroll
      for (int k = 0; k < BC; ++k) acc[k] += v[k];
    }
    store_vec<BC>(dst + b0, acc);
  }
}

// one warp per large bin of a CSR (`large_bins`: their places in it): lane
// l sums members l, l+32, ... in order, then a fixed shuffle tree
template <int BC>
__global__ void segsum_large_kernel(const float* __restrict__ folded, const int* __restrict__ perm,
                                    const int* __restrict__ offsets, const int* __restrict__ bins,
                                    const int* __restrict__ large_bins, int n_large,
                                    float* __restrict__ out, int B) {
  const int lane = threadIdx.x & 31;
  const int w = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  if (w >= n_large) return;
  const int s = __ldg(large_bins + w);
  const int lo = __ldg(offsets + s), hi = __ldg(offsets + s + 1);
  float* dst = out + (long long)(bins ? __ldg(bins + s) : s) * B;
  for (int b0 = 0; b0 < B; b0 += BC) {
    float acc[BC], v[BC];
#pragma unroll
    for (int k = 0; k < BC; ++k) acc[k] = 0.f;
    for (int e = lo + lane; e < hi; e += 32) {
      load_vec<BC>(folded + (long long)__ldg(perm + e) * B + b0, v);
#pragma unroll
      for (int k = 0; k < BC; ++k) acc[k] += v[k];
    }
#pragma unroll
    for (int k = 0; k < BC; ++k)
      for (int off = 16; off > 0; off >>= 1) acc[k] += __shfl_down_sync(0xffffffffu, acc[k], off);
    if (lane == 0) store_vec<BC>(dst + b0, acc);
  }
}

Geom geom_of(const int* g) {
  return Geom{g[0], g[1], g[2], g[3], g[4], g[5], g[6], g[7], g[8], g[9], g[10], g[11]};
}

int blocks_for(long long n, int per_block) { return (int)((n + per_block - 1) / per_block); }

// The rfp2 tile kernels' launch: T x T blocks on the full grid, T x (the
// range's tile rows) on a range.
dim3 tile_grid(const Geom& g) {
  const int T = blocks_for(g.c2, kTile);
  return dim3(T, g.k_n > 0 ? g.k_n : T);
}

// The flat kernels' launch: a block per 128 points of a core row; on a
// range, the range's axis over its launch rows only.
dim3 flat_grid(const Geom& g) {
  dim3 grid(blocks_for(g.c2, kThreads), g.c1, g.c0);
  if (g.k_n > 0) (g.r_ax == 0 ? grid.z : grid.y) = g.k_n;
  return grid;
}

template <int BC, int V>
void launch_expand_rfp2(const float* tab, const int* idx, float* out, const Geom& g, int B,
                        cudaStream_t s) {
  const dim3 block(kTile, kTileRows);
  if (g.k_n > 0) expand_rfp2_kernel<BC, V, true><<<tile_grid(g), block, 0, s>>>(tab, idx, out, g, B);
  else expand_rfp2_kernel<BC, V, false><<<tile_grid(g), block, 0, s>>>(tab, idx, out, g, B);
}

template <int BC>
void launch_expand_flat(const float* tab, const int* idx, float* out, const Geom& g, int B,
                        cudaStream_t s) {
  if (g.k_n > 0) expand_flat_kernel<BC, true><<<flat_grid(g), kThreads, 0, s>>>(tab, idx, out, g, B);
  else expand_flat_kernel<BC, false><<<flat_grid(g), kThreads, 0, s>>>(tab, idx, out, g, B);
}

template <int BC, bool kRange>
void launch_fold(const float* cot, float* folded, const Geom& g, int B, cudaStream_t s) {
  if (g.m >= 0)
    collapse_fold_rfp2_kernel<BC, kRange><<<tile_grid(g), dim3(kTile, kTileRows), 0, s>>>(
        cot, folded, g, B);
  else
    collapse_fold_flat_kernel<BC, kRange><<<flat_grid(g), kThreads, 0, s>>>(cot, folded, g, B);
}

template <bool kRange>
void launch_fold_any(const float* cot, float* folded, const Geom& g, int B, cudaStream_t s) {
  if (B % 4 == 0) launch_fold<4, kRange>(cot, folded, g, B, s);
  else if (B % 2 == 0) launch_fold<2, kRange>(cot, folded, g, B, s);
  else launch_fold<1, kRange>(cot, folded, g, B, s);
}

template <int BC>
int launch_segsum(const float* folded, const int* perm, const int* offsets, const int* bins,
                  int n_bins, int large, const int* large_bins, int n_large, float* out, int B,
                  cudaStream_t s) {
  const int threads = 256;
  segsum_small_kernel<BC><<<blocks_for(n_bins, threads), threads, 0, s>>>(
      folded, perm, offsets, bins, n_bins, large, out, B);
  const int err = (int)cudaGetLastError();
  if (err || n_large == 0) return err;
  segsum_large_kernel<BC><<<blocks_for((long long)n_large * 32, threads), threads, 0, s>>>(
      folded, perm, offsets, bins, large_bins, n_large, out, B);
  return (int)cudaGetLastError();
}

// The fold, then the segment sum (bins null: the whole index's CSR).
int fold_and_sum(const float* cot, float* folded, const int* perm, const int* offsets,
                 const int* bins, int n_bins, int large, const int* large_bins, int n_large,
                 float* out, const Geom& g, int B, cudaStream_t s) {
  if (g.k_n > 0) launch_fold_any<true>(cot, folded, g, B, s);
  else launch_fold_any<false>(cot, folded, g, B, s);
  const int err = (int)cudaGetLastError();
  if (err) return err;
  if (B % 4 == 0)
    return launch_segsum<4>(folded, perm, offsets, bins, n_bins, large, large_bins, n_large, out, B, s);
  if (B % 2 == 0)
    return launch_segsum<2>(folded, perm, offsets, bins, n_bins, large, large_bins, n_large, out, B, s);
  return launch_segsum<1>(folded, perm, offsets, bins, n_bins, large, large_bins, n_large, out, B, s);
}

}  // namespace

// geom: n0, n1, n2, c0, c1, c2, m (m < 0: flat layout), r_ax, r_lo, r_n (the
// grid side's rows, note 6), k_lo, k_n (a range's launch rows; k_n = 0: every
// tile or core row); the host checks that c1 and c0 fit a launch grid's y and
// z extents
extern "C" int nt_expand_to_grid(const void* tab, const void* idx, void* out, const int* geom,
                                 int B, void* stream) {
  const Geom g = geom_of(geom);
  const float* t = (const float*)tab;
  const int* i = (const int*)idx;
  float* o = (float*)out;
  cudaStream_t s = (cudaStream_t)stream;
  if (g.m < 0) {
    if (B % 4 == 0) launch_expand_flat<4>(t, i, o, g, B, s);
    else if (B % 2 == 0) launch_expand_flat<2>(t, i, o, g, B, s);
    else launch_expand_flat<1>(t, i, o, g, B, s);
  } else if (B == 1 && g.n2 % 4 == 0) {
    launch_expand_rfp2<1, 4>(t, i, o, g, B, s);
  } else if (B % 4 == 0) {
    launch_expand_rfp2<4, 1>(t, i, o, g, B, s);
  } else if (B % 2 == 0) {
    launch_expand_rfp2<2, 1>(t, i, o, g, B, s);
  } else {
    launch_expand_rfp2<1, 1>(t, i, o, g, B, s);
  }
  return (int)cudaGetLastError();
}

// perm, offsets: the CSR form of the packed index (its stable argsort and
// each bin's first place in it); bins of more than `large` members, listed
// in large_bins, are summed by a warp
extern "C" int nt_collapse_from_grid(const void* cot, void* folded, const void* perm,
                                     const void* offsets, int n_unique, int large,
                                     const void* large_bins, int n_large, void* out,
                                     const int* geom, int B, void* stream) {
  return fold_and_sum((const float*)cot, (float*)folded, (const int*)perm, (const int*)offsets,
                      nullptr, n_unique, large, (const int*)large_bins, n_large, (float*)out,
                      geom_of(geom), B, (cudaStream_t)stream);
}

// K2r: the range's CSR (note 6): perm the packed points with an image in the
// range, sorted by bin; bins the bins they touch, offsets each one's first
// place in perm (n_bins + 1 of them), large_bins the places in bins of those
// with more than `large` members; every other bin of out (n_unique) is 0
extern "C" int nt_collapse_from_grid_rows(const void* cot, void* folded, const void* perm,
                                          const void* offsets, const void* bins, int n_bins,
                                          int large, const void* large_bins, int n_large,
                                          void* out, int n_unique, const int* geom, int B,
                                          void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int err = (int)cudaMemsetAsync(out, 0, (size_t)n_unique * B * sizeof(float), s);
  if (err) return err;
  return fold_and_sum((const float*)cot, (float*)folded, (const int*)perm, (const int*)offsets,
                      (const int*)bins, n_bins, large, (const int*)large_bins, n_large,
                      (float*)out, geom_of(geom), B, s);
}

extern "C" const char* nt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
