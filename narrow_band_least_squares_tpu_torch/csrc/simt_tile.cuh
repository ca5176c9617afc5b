// The fp32 CUDA-core tile for Hopper (sm_90a), shared by the kernels whose
// products run in IEEE fp32 (matmul_precision 'highest'): a 64-row x
// 128-column tile of C = A . B accumulated in registers with one fmaf per
// term, K ascending, then either reduced to a masked first maximum per row
// or stored.
//
// What bounds it: the fp32 FMA rate (128 per SM per clock).  The design is
// the one that keeps the FMA pipes fed from shared memory:
//   - each thread owns an 8 x 8 block of the tile, two 4-row groups BM/2
//     apart by two 4-column groups BN/2 apart, so one k step reads four
//     float4 from shared memory for 64 FMAs (4 FMAs per float read) and the
//     lanes of a warp read 256 contiguous bytes of B without bank conflicts;
//   - 128 threads and at most 128 registers a thread, so four CTAs share an
//     SM: the canonical buckets' 330-350 tiles are one wave of two or three
//     CTAs an SM (a 128 x 128 tile gave 165-182 CTAs: 1.3 waves);
//   - K streams through two shared-memory stages, one __syncthreads a
//     chunk: before the math on the current chunk, the next chunk's B is
//     copied to the other stage by cp.async (16 bytes a copy, no registers)
//     and its A loaded into registers, stored transposed to K-major after
//     the math.
// Operands reach the tile through loaders (RowsA / RowsB: row-major
// matrices):
//   A.load(v, k): the float4 A[row v of this thread][k .. k+3];
//   B.src(k, n): a valid address, that of B[k][n .. n+3] (n within the
//     tile) where B.in(k), whose 16 bytes are then copied; zeros elsewhere.
// A loader should only issue loads: their values are first used after the
// math of the current chunk, which hides their latency.  (A loader that
// formed each value from its loads, such as a cross-spectrum from two
// spectra, waited for them before the math: 28% slower on the H100.)
// No split-K: every output is the same K-ordered fmaf chain whatever the
// grid, so a row's value never depends on how many rows share the launch.
//
// Plain CUDA: no PyTorch header.

#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

namespace nbls {
namespace simt {

constexpr int BM = 64;                       // rows per CTA
constexpr int BN = 128;                      // columns (lags) per CTA
constexpr int TM = 8;                        // rows per thread
constexpr int TN = 8;                        // columns per thread
constexpr int NT = (BM / TM) * (BN / TN);    // 128 threads
constexpr int LANES = BN / TN;               // 16 lanes share a row
constexpr int MIN_CTAS = 4;                  // CTAs an SM holds: <= 128 registers
constexpr int A_PAD = 4;                     // keeps float4 reads aligned

static_assert(LANES == 16, "the row reductions shuffle over 16 lanes");
static_assert(NT >= BM, "one thread per row checks the tile's lag ranges");

template <int BK>
struct Smem {
  float a[2][BK][BM + A_PAD];  // A chunks, K-major
  float b[2][BK][BN];          // B chunks
};

// Which float4 of a chunk thread t loads: A row a_row(t, v) at k offset
// a_k(t); B row b_k(t, v) at column b_n(t, v).
template <int BK>
struct Map {
  static constexpr int AQ = BK / 4;            // float4 per A row per chunk
  static constexpr int A_VEC = BM * AQ / NT;   // A float4 per thread
  static constexpr int BQ = BN / 4;            // float4 per B row
  static constexpr int B_VEC = BK * BQ / NT;   // B float4 per thread
  static_assert(A_VEC * NT == BM * AQ && B_VEC * NT == BK * BQ,
                "the chunk must split evenly over the threads");
  __device__ static int a_row(int t, int v) { return t / AQ + v * (NT / AQ); }
  __device__ static int a_k(int t) { return (t % AQ) * 4; }
  __device__ static int b_k(int t, int v) { return (t + v * NT) / BQ; }
  __device__ static int b_n(int t, int v) { return ((t + v * NT) % BQ) * 4; }
};

// Tile row of accumulator row i of a thread in row group ty; tile column of
// accumulator column j of a thread in column group tx.  Columns ascend with
// j, so a thread scans its lags in order.
__device__ __forceinline__ int acc_row(int ty, int i) {
  return (i >> 2) * (BM / 2) + ty * 4 + (i & 3);
}
__device__ __forceinline__ int acc_col(int tx, int j) {
  return (j >> 2) * (BN / 2) + tx * 4 + (j & 3);
}

__device__ __forceinline__ float4 ldg4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

// The loaders of a row-major fp32 matrix, 16-byte aligned rows:
//   RowsA: rows row0 .. row0 + BM of A (rows, ld), zeros past `rows`;
//   RowsB: columns col0 .. col0 + BN of B (krows, ld), zeros past `krows`.
template <int BK>
struct RowsA {
  const float* row[Map<BK>::A_VEC];
  __device__ RowsA(const float* a, int row0, int rows, int ld) {
#pragma unroll
    for (int v = 0; v < Map<BK>::A_VEC; ++v) {
      const int r = row0 + Map<BK>::a_row(threadIdx.x, v);
      row[v] = r < rows ? a + (size_t)r * ld : nullptr;
    }
  }
  __device__ float4 load(int v, int k) const {
    return row[v] != nullptr ? ldg4(row[v] + k) : make_float4(0.f, 0.f, 0.f, 0.f);
  }
};

struct RowsB {
  const float* base;  // B + col0
  int ld, krows;
  __device__ bool in(int k) const { return k < krows; }
  __device__ const float* src(int k, int n) const {
    return base + (size_t)min(k, krows - 1) * ld + n;
  }
};

// 16 bytes from global memory at src to shared memory at dst,
// asynchronously; zeros instead unless `copy`.
__device__ __forceinline__ void cp_async16(void* dst, const float* src,
                                           bool copy) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(d),
               "l"(src), "r"(copy ? 16 : 0)
               : "memory");
}

// acc[i][j] = sum over k < nk * BK of A[i][k0 + k] * B[k0 + k][j], one fmaf
// a term, k ascending; k0 = k_begin.
template <int BK, class ALoad, class BLoad>
__device__ __forceinline__ void mainloop(Smem<BK>& s, const ALoad& A,
                                         const BLoad& B, int k_begin, int nk,
                                         float (&acc)[TM][TN]) {
  using M = Map<BK>;
  const int t = threadIdx.x, tx = t % LANES, ty = t / LANES;
  float4 ra[M::A_VEC];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  // A into registers, B straight into stage `buf`
  auto fetch = [&](int k0, int buf) {
#pragma unroll
    for (int v = 0; v < M::A_VEC; ++v) ra[v] = A.load(v, k0 + M::a_k(t));
#pragma unroll
    for (int v = 0; v < M::B_VEC; ++v) {
      const int k = M::b_k(t, v), n = M::b_n(t, v);
      cp_async16(&s.b[buf][k][n], B.src(k0 + k, n), B.in(k0 + k));
    }
    asm volatile("cp.async.commit_group;" ::: "memory");
  };
  auto stash = [&](int buf) {
#pragma unroll
    for (int v = 0; v < M::A_VEC; ++v) {
      const int r = M::a_row(t, v), k = M::a_k(t);
      s.a[buf][k][r] = ra[v].x;
      s.a[buf][k + 1][r] = ra[v].y;
      s.a[buf][k + 2][r] = ra[v].z;
      s.a[buf][k + 3][r] = ra[v].w;
    }
    asm volatile("cp.async.wait_group 0;" ::: "memory");
  };

  if (nk > 0) {
    fetch(k_begin, 0);
    stash(0);
  }
  __syncthreads();
  for (int kc = 0; kc < nk; ++kc) {
    const int buf = kc & 1;
    // in flight during the math; the other stage was last read before the
    // previous barrier
    if (kc + 1 < nk) fetch(k_begin + (kc + 1) * BK, buf ^ 1);
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(&s.a[buf][k][ty * 4]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&s.a[buf][k][BM / 2 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&s.b[buf][k][tx * 4]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&s.b[buf][k][BN / 2 + tx * 4]);
      const float a[TM] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[TN] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    if (kc + 1 < nk) stash(buf ^ 1);
    __syncthreads();
  }
}

// True if some row of the tile searches a lag in [lag0, lag0 + BN); the
// whole CTA must call it.  bounds(r, lo, hi) gives row r's lag range.
template <class Bounds>
__device__ __forceinline__ bool tile_needed(int row0, int lag0, int R,
                                            const Bounds& bounds) {
  bool needed = false;
  const int t = threadIdx.x;
  if (t < BM && row0 + t < R) {
    int lo, hi;
    bounds(row0 + t, lo, hi);
    needed = lo <= hi && lo <= lag0 + BN - 1 && hi >= lag0;
  }
  return __syncthreads_or(needed);
}

// The partials of a tile that no row searches: (-inf, 0) for each row.
__device__ __forceinline__ void skip_partials(int row0, int R, float* part_val,
                                              int* part_idx) {
  const int t = threadIdx.x;
  if (t < BM && row0 + t < R) {
    part_val[row0 + t] = -CUDART_INF_F;
    part_idx[row0 + t] = 0;
  }
}

// Per row of the tile, the first maximum over lags in [lo, hi] below nlag:
// each thread scans its columns in ascending order with a strict >, then
// the 16 lanes of the row reduce keeping the smaller lag on equal values.
// A row with no such lag gives (-inf, 0).  Writes part_val/part_idx[r].
template <class Bounds>
__device__ __forceinline__ void first_max_partials(const float (&acc)[TM][TN],
                                                   int row0, int lag0, int R,
                                                   int nlag,
                                                   const Bounds& bounds,
                                                   float* part_val,
                                                   int* part_idx) {
  const int t = threadIdx.x, tx = t % LANES, ty = t / LANES;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = row0 + acc_row(ty, i);
    int lo = 1, hi = 0;  // empty range for rows past R
    if (r < R) bounds(r, lo, hi);
    float best = -CUDART_INF_F;
    int bidx = 0;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int col = lag0 + acc_col(tx, j);
      if (col >= lo && col <= hi && col < nlag && acc[i][j] > best) {
        best = acc[i][j];
        bidx = col;
      }
    }
#pragma unroll
    for (int off = LANES / 2; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, best, off);
      const int oi = __shfl_xor_sync(0xffffffffu, bidx, off);
      if (ov > best || (ov == best && oi < bidx)) {
        best = ov;
        bidx = oi;
      }
    }
    if (tx == 0 && r < R) {
      part_val[r] = best;
      part_idx[r] = bidx;
    }
  }
}

// first_max_partials, and beside each row's maximum the correlations at its
// lag - 1 and lag + 1 (0 outside the tile or at or past nlag; the fold
// patches those from the adjacent tile) and the tile's first and last
// column, unmasked: planes 0-3 at nb[k * plane + r].  The 16 lanes of a row
// hold columns acc_col(tx, j); the lane that holds a neighbour shares it.
template <class Bounds>
__device__ __forceinline__ void first_max_nb_partials(
    const float (&acc)[TM][TN], int row0, int lag0, int R, int nlag,
    const Bounds& bounds, float* part_val, int* part_idx, float* nb,
    size_t plane) {
  const int t = threadIdx.x, tx = t % LANES, ty = t / LANES;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = row0 + acc_row(ty, i);
    int lo = 1, hi = 0;  // empty range for rows past R
    if (r < R) bounds(r, lo, hi);
    float best = -CUDART_INF_F;
    int bidx = 0;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int col = lag0 + acc_col(tx, j);
      if (col >= lo && col <= hi && col < nlag && acc[i][j] > best) {
        best = acc[i][j];
        bidx = col;
      }
    }
#pragma unroll
    for (int off = LANES / 2; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, best, off);
      const int oi = __shfl_xor_sync(0xffffffffu, bidx, off);
      if (ov > best || (ov == best && oi < bidx)) {
        best = ov;
        bidx = oi;
      }
    }
    float m = 0.f, p = 0.f;
    bool hm = false, hp = false;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int col = lag0 + acc_col(tx, j);
      if (col == bidx - 1) { m = acc[i][j]; hm = true; }
      if (col == bidx + 1 && col < nlag) { p = acc[i][j]; hp = true; }
    }
#pragma unroll
    for (int off = LANES / 2; off > 0; off >>= 1) {
      const float om = __shfl_xor_sync(0xffffffffu, m, off);
      const bool ohm = __shfl_xor_sync(0xffffffffu, (int)hm, off) != 0;
      const float op = __shfl_xor_sync(0xffffffffu, p, off);
      const bool ohp = __shfl_xor_sync(0xffffffffu, (int)hp, off) != 0;
      if (ohm && !hm) { m = om; hm = true; }
      if (ohp && !hp) { p = op; hp = true; }
    }
    if (r < R) {
      if (tx == 0) {
        part_val[r] = best;
        part_idx[r] = bidx;
        nb[r] = m;
        nb[plane + r] = p;
        nb[2 * plane + r] = acc[i][0];         // column lag0
      }
      if (tx == LANES - 1) nb[3 * plane + r] = acc[i][TN - 1];  // lag0 + BN - 1
    }
  }
}

// out[r][col0 + c] = acc, negated in columns >= neg_from (a multiple of 4);
// rows >= M are skipped.  out rows are ldo floats, ldo a multiple of 4.
__device__ __forceinline__ void store_tile(const float (&acc)[TM][TN], int row0,
                                           int col0, int M, float* out,
                                           int ldo, int neg_from) {
  const int t = threadIdx.x, tx = t % LANES, ty = t / LANES;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = row0 + acc_row(ty, i);
    if (r >= M) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = col0 + acc_col(tx, 4 * h);
      const float s = col >= neg_from ? -1.f : 1.f;
      const float4 o = make_float4(s * acc[i][4 * h], s * acc[i][4 * h + 1],
                                   s * acc[i][4 * h + 2], s * acc[i][4 * h + 3]);
      *reinterpret_cast<float4*>(out + (size_t)r * ldo + col) = o;
    }
  }
}

}  // namespace simt
}  // namespace nbls
