// The tensor-core lag-search tile for Hopper (sm_90a), shared by the kernels
// that end in a masked first-max over an inverse-DFT product:
//
//   - the tf32 split of an fp32 value (cvt.rna, round to nearest, ties away);
//   - TMA loads of 128-byte-wide K-major tiles (32 fp32, 128B swizzle) into
//     a ring of shared-memory stages, each guarded by an mbarrier;
//   - the 64 x 128 x 8 wgmma with tf32 operands and fp32 accumulators, both
//     operands K-major in shared memory (the only layout wgmma takes for
//     tf32);
//   - the masked first-max epilogue on the accumulator fragment, and the
//     in-order fold of per-lag-tile partials; the same with the peak's two
//     neighbouring correlations (the three-point parabola's inputs);
//   - the warp-specialised tile kernel built from them (tc_tile_kernel: a
//     TMA producer, three wgmma consumer warpgroups, a first-max or a store
//     epilogue) and its host-side launch helpers, used by icorr_peak
//     (xcorr_peak_tc.cu) and by both products of fused_xcorr_bucket
//     (fused_xcorr.cu).
//
// A tf32 product fed raw fp32 truncates the low 13 mantissa bits, so a
// caller that wants more than one tf32 pass splits explicitly:
//   x = hi + lo,  hi = rna_tf32(x),  lo = rna_tf32(x - hi)
//   a.b ~= a_lo.b_hi + a_hi.b_lo + a_hi.b_hi     (3xTF32, fp32 accumulate)
// which keeps about 21-22 mantissa bits (the pattern of CUTLASS's
// OpMultiplyAddFastF32).  One pass over the hi parts is 1xTF32.
//
// Plain CUDA: no PyTorch header, so a source that includes this builds in
// seconds.

#pragma once

#include <cuda.h>  // CUtensorMap (types only; no driver library is linked)
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace nbls {

constexpr int TILE_M = 64;         // rows per consumer warpgroup (wgmma M)
constexpr int TILE_N = 128;        // lags per tile (wgmma N)
constexpr int TILE_K = 32;         // fp32 per 128-byte swizzled row
constexpr int ACC = TILE_N / 2;    // fp32 accumulators per thread
constexpr int WG_THREADS = 128;    // one warpgroup

// ---- tf32 split -----------------------------------------------------------

__device__ __forceinline__ float tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return __uint_as_float(r & 0xffffe000u);
}

// hi = rna(x) and, when lo != nullptr, lo = rna(x - hi); n4 float4 values.
__global__ void tf32_split_kernel(const float4* __restrict__ x,
                                  float4* __restrict__ hi,
                                  float4* __restrict__ lo, long long n4) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n4;
       i += (long long)gridDim.x * blockDim.x) {
    const float4 v = x[i];
    const float4 h = make_float4(tf32_rna(v.x), tf32_rna(v.y), tf32_rna(v.z),
                                 tf32_rna(v.w));
    hi[i] = h;
    if (lo != nullptr)
      lo[i] = make_float4(tf32_rna(v.x - h.x), tf32_rna(v.y - h.y),
                          tf32_rna(v.z - h.z), tf32_rna(v.w - h.w));
  }
}

// ---- shared memory, mbarriers, TMA ----------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Spin until the phase of `bar` with this parity has completed.  A wait of
// more than ~2^26 tries is a broken pipeline: trap, so that the launch
// fails instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  for (uint32_t tries = 0; !done; ++tries) {
    if (tries == (1u << 26)) __trap();
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// One 2-D tile (c0 along K, c1 along rows) into shared memory; completion
// is counted in bytes on `bar`.  Rows past the tensor's end arrive as 0.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

// ---- wgmma ----------------------------------------------------------------

// Shared-memory matrix descriptor of a K-major tile with 128-byte rows and
// the 128B swizzle, as TMA writes it: 8-row core groups 1024 bytes apart
// (SBO); LBO is unused for this layout.  The tile must be 1024-byte
// aligned; a k-step of 8 tf32 (32 bytes) advances the start address by 2.
__device__ __forceinline__ uint64_t sw128_desc(const void* tile) {
  const uint64_t addr = smem_u32(tile);
  return ((addr & 0x3FFFFull) >> 4) | (1ull << 16) | ((1024ull >> 4) << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous products.
__device__ __forceinline__ void fence_acc(float (&d)[ACC]) {
#pragma unroll
  for (int i = 0; i < ACC; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 128, fp32) = A (64 x 8, tf32, K-major) . B (128 x 8, tf32,
// K-major)^T, plus d unless scale_d is 0.  Warpgroup-wide and asynchronous:
// commit and wait before reading d.
__device__ __forceinline__ void wgmma_m64n128k8_tf32(float (&d)[ACC],
                                                     uint64_t desc_a,
                                                     uint64_t desc_b,
                                                     int scale_d = 1) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// One 32-wide K block of a 64 x 128 tile into d (added to d if
// `accumulate`, else overwriting it): 4 k-steps of 8, each with the NPROD
// products of the split (3: lo.hi + hi.lo + hi.hi, the small terms first;
// 1: hi.hi).
// a_hi/a_lo/b_hi/b_lo point at 1024-aligned tiles.
//
// The tensor cores add into their fp32 accumulator without rounding to
// nearest (measured on the H100: 3xTF32 summed over 2432 K in one
// accumulator drifted 1.8e-5 of the peak from fp32), so a caller sums a
// few K blocks at a time and folds them in registers with fp32 adds.
template <int NPROD>
__device__ __forceinline__ void tile_kblock(float (&d)[ACC], const void* a_hi,
                                            const void* a_lo, const void* b_hi,
                                            const void* b_lo, bool accumulate) {
  const uint64_t ah = sw128_desc(a_hi), bh = sw128_desc(b_hi);
  const uint64_t al = sw128_desc(a_lo), bl = sw128_desc(b_lo);
#pragma unroll
  for (int k = 0; k < TILE_K / 8; ++k) {
    const uint64_t dk = 2 * k;  // 32 bytes, in 16-byte units
    const int scale_d = accumulate || k > 0;
    if (NPROD == 3) {
      wgmma_m64n128k8_tf32(d, al + dk, bh + dk, scale_d);
      wgmma_m64n128k8_tf32(d, ah + dk, bl + dk);
      wgmma_m64n128k8_tf32(d, ah + dk, bh + dk);
    } else {
      wgmma_m64n128k8_tf32(d, ah + dk, bh + dk, scale_d);
    }
  }
}

// ---- the masked first-max epilogue ----------------------------------------

// In a 64 x 128 accumulator fragment, warp w of the warpgroup holds rows
// 16w..16w+15; lane l holds rows l/4 ("a") and l/4 + 8 ("b"), and register
// 4j + e (+2 for row b) holds lag 8j + 2(l%4) + e.  The registers do not
// run in lag order across lanes, so each thread scans its own lags in
// ascending order (j, then e) with a strict >, and the four lanes of a row
// then reduce keeping the smaller lag on equal values: the result is the
// first maximum of the tile over lags in [lo, hi] and below nlag.
// A row with no such lag gives (-inf, 0).
struct TileBest {
  float va, vb;
  int ia, ib;
};

__device__ __forceinline__ void pick(float& v, int& i, float ov, int oi) {
  if (ov > v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

__device__ __forceinline__ TileBest tile_first_max(const float (&d)[ACC],
                                                   int lag0, int nlag,
                                                   int lo_a, int hi_a,
                                                   int lo_b, int hi_b) {
  const int q = threadIdx.x & 3;
  TileBest r{-CUDART_INF_F, -CUDART_INF_F, 0, 0};
#pragma unroll
  for (int j = 0; j < TILE_N / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = lag0 + 8 * j + 2 * q + e;
      const float va = d[4 * j + e], vb = d[4 * j + 2 + e];
      if (col < nlag && col >= lo_a && col <= hi_a && va > r.va) {
        r.va = va;
        r.ia = col;
      }
      if (col < nlag && col >= lo_b && col <= hi_b && vb > r.vb) {
        r.vb = vb;
        r.ib = col;
      }
    }
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    const float va = __shfl_xor_sync(0xffffffffu, r.va, off);
    const int ia = __shfl_xor_sync(0xffffffffu, r.ia, off);
    const float vb = __shfl_xor_sync(0xffffffffu, r.vb, off);
    const int ib = __shfl_xor_sync(0xffffffffu, r.ib, off);
    pick(r.va, r.ia, va, ia);
    pick(r.vb, r.ib, vb, ib);
  }
  return r;
}

// Folds the per-lag-tile partials (ntiles x R) in ascending tile order,
// replacing the best only on a strictly greater value: the first maximum.
__global__ void peak_merge_kernel(const float* __restrict__ part_val,
                                  const int* __restrict__ part_idx,
                                  float* __restrict__ peak,
                                  int* __restrict__ idx, int R, int ntiles) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  float best = -CUDART_INF_F;
  int bidx = 0;
  for (int j = 0; j < ntiles; ++j) {
    const float v = part_val[(size_t)j * R + r];
    if (v > best) {
      best = v;
      bidx = part_idx[(size_t)j * R + r];
    }
  }
  peak[r] = best;
  idx[r] = bidx;
}

// ---- the neighbour epilogue (sub-sample delays) ------------------------------
//
// Beside a row's first maximum (ia, va) of a tile, the correlations at
// ia - 1 and ia + 1 of the same accumulator: the product that gave the peak,
// so at every precision the neighbours carry the peak's own rounding.  The
// lanes of a row hold columns 8j + 2q + e (q = lane % 4), so each lane
// takes the neighbours it holds and the quad shares them.  A neighbour
// outside the tile or at or past nlag is 0 here: the fold patches the
// first from the adjacent tile's edge column (peak_merge_nb_kernel).
// Neighbours are taken from the unmasked correlation: they may lie outside
// [lo, hi].

__device__ __forceinline__ void take_flagged(float& v, bool& has, int off) {
  const float ov = __shfl_xor_sync(0xffffffffu, v, off);
  const bool oh = __shfl_xor_sync(0xffffffffu, (int)has, off) != 0;
  if (oh && !has) {
    v = ov;
    has = true;
  }
}

// (cm_a, cp_a, cm_b, cp_b) of rows a and b, given their tile maxima ia, ib
struct TileNb {
  float ma, pa, mb, pb;
};

__device__ __forceinline__ TileNb tile_neighbours(const float (&d)[ACC],
                                                  int lag0, int nlag, int ia,
                                                  int ib) {
  const int q = threadIdx.x & 3;
  float v[4] = {0.f, 0.f, 0.f, 0.f};
  bool has[4] = {false, false, false, false};
#pragma unroll
  for (int j = 0; j < TILE_N / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = lag0 + 8 * j + 2 * q + e;
      const float va = d[4 * j + e], vb = d[4 * j + 2 + e];
      if (col == ia - 1) { v[0] = va; has[0] = true; }
      if (col == ia + 1 && col < nlag) { v[1] = va; has[1] = true; }
      if (col == ib - 1) { v[2] = vb; has[2] = true; }
      if (col == ib + 1 && col < nlag) { v[3] = vb; has[3] = true; }
    }
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1)
#pragma unroll
    for (int k = 0; k < 4; ++k) take_flagged(v[k], has[k], off);
  return TileNb{v[0], v[1], v[2], v[3]};
}

// The neighbour partials of a lag tile: four planes of ntiles x R after
// part_val / part_idx, plane 0 cm, 1 cp, 2 the tile's first column, 3 its
// last column (both unmasked), each at [plane][tile][row].
struct NbPlanes {
  float* base;
  size_t plane;  // ntiles * R
  __device__ float& at(int k, size_t i) const { return base[k * plane + i]; }
};

// Folds the partials in ascending tile order with a strict >, as
// peak_merge_kernel does, carrying the winner's neighbours; a winner on
// its tile's first (last) column takes cm (cp) from the previous (next)
// tile's last (first) column.  A row with no valid lag gives (-inf, 0, 0,
// 0); a peak at lag 0 has cm 0, one at nlag - 1 has cp 0.
__global__ void peak_merge_nb_kernel(const float* __restrict__ part_val,
                                     const int* __restrict__ part_idx,
                                     const float* __restrict__ part_nb,
                                     float* __restrict__ peak,
                                     int* __restrict__ idx,
                                     float* __restrict__ cm,
                                     float* __restrict__ cp, int R,
                                     int ntiles, int tile_n) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  const size_t plane = (size_t)ntiles * R;
  float best = -CUDART_INF_F, bm = 0.f, bp = 0.f;
  int bidx = 0;
  for (int j = 0; j < ntiles; ++j) {
    const size_t i = (size_t)j * R + r;
    const float v = part_val[i];
    if (v > best) {
      best = v;
      bidx = part_idx[i];
      bm = part_nb[i];
      bp = part_nb[plane + i];
      if (bidx == j * tile_n && j > 0) bm = part_nb[3 * plane + i - R];
      if (bidx == (j + 1) * tile_n - 1 && j + 1 < ntiles)
        bp = part_nb[2 * plane + i + R];
    }
  }
  peak[r] = best;
  idx[r] = bidx;
  cm[r] = bm;
  cp[r] = bp;
}


// ---- the warp-specialised tile kernel ---------------------------------------
//
// One CTA per (192-row, 128-column) tile of A (R, K) . Bt (ncols, K)^T, both
// K-major fp32 matrices read by TMA as tf32 (their hi planes, and their lo
// planes at NPROD 3): one producer thread keeps loads of 32-wide K blocks in
// flight through a ring of shared-memory stages (2 at NPROD 3, 4 at 1);
// three consumer warpgroups of 64 rows run m64n128k8 wgmma on the stage that
// arrived and release it.  The tensor cores' own fp32 accumulation does not
// round to nearest, so the products of each K block (each 4 blocks at
// NPROD 1) go to a fresh fragment that the warpgroup adds into its running
// sum in registers; the other warpgroups' products keep the tensor cores
// busy meanwhile.  The producer warpgroup hands most of its registers to
// the consumers (setmaxnreg).  No split-K: every (row, column) value is the
// same K-ordered sum whatever R or the grid.  Rows past R arrive from TMA
// as zeros.
//
// Epilogues:
//   EPI_PEAK: per row, the first maximum over columns in [lo, hi] below
//     ncols (row r's bounds are lo[(row_base + r) / bdiv], and hi alike:
//     row_base places the launch's rows in a larger problem), written as the
//     tile's partial at part_val/part_idx[blockIdx.y * R + r]; a tile whose
//     rows all search outside its 128 columns is skipped.
//   EPI_PEAK_NB: EPI_PEAK, and per row of the tile its maximum's two
//     neighbouring sums (tile_neighbours) and the tile's first and last
//     column, the four planes of NbPlanes at part_nb; a tile is skipped only
//     when no row's [lo - 1, hi + 1] meets it, since a peak at lo or hi
//     takes a neighbour from one column past the band;
//   EPI_STORE: out[r * ldo + col] = the sum, negated in columns >= neg_from;
//     ncols must be a multiple of 128.  blockIdx.z = z sums only K part
//     [z * kpart, (z + 1) * kpart) and writes to out + z * R * ldo, so that
//     a caller can add the parts in a fixed order (kpart a multiple of 32).

constexpr int CONSUMERS = 3;                            // consumer warpgroups
constexpr int TC_BM = CONSUMERS * TILE_M;               // 192 rows per CTA
constexpr int TC_THREADS = (CONSUMERS + 1) * WG_THREADS;  // + the producer's
// Registers a thread after setmaxnreg: the producer warpgroup gives up most
// of its own to the consumers, which hold two 64-float fragments each
// (24 x 128 + 160 x 384 <= 65,536).
constexpr int PRODUCER_REGS = 24;
constexpr int CONSUMER_REGS = 160;
constexpr int A_TILE = TC_BM * TILE_K * 4;              // 24 KB
constexpr int B_TILE = TILE_N * TILE_K * 4;             // 16 KB

template <int NPROD>
struct TcCfg {
  static_assert(NPROD == 1 || NPROD == 3, "1xTF32 or 3xTF32");
  static constexpr int PLANES = NPROD == 3 ? 2 : 1;  // hi (and lo) of A and B
  static constexpr int STAGE = PLANES * (A_TILE + B_TILE);
  // 160 KB at NPROD 3 and 1
  static constexpr int STAGES = NPROD == 3 ? 2 : 4;
  // K blocks whose products the tensor cores sum before the fp32 fold: 12
  // truncating additions between folds at NPROD 3 (3 x 4 k-steps), 16 at
  // 1, where a fold per block would drain the pipe every 4 products
  static constexpr int FOLD = NPROD == 3 ? 1 : 4;
  static constexpr int SMEM = STAGES * STAGE + 2 * STAGES * 8 + 1024;
};

enum : int { EPI_PEAK = 0, EPI_STORE = 1, EPI_PEAK_NB = 2 };

struct TcOut {
  const int* lo;    // EPI_PEAK: lag bounds, one per bdiv rows
  const int* hi;
  int bdiv;
  int row_base;     // EPI_PEAK: the launch's row 0 in the rows of lo / hi
  float* part_val;  // EPI_PEAK: partials, (ncols / 128) x R
  int* part_idx;
  float* out;       // EPI_STORE: R x ldo
  int ldo;
  int neg_from;
  float* part_nb;   // EPI_PEAK_NB: 4 planes of (ncols / 128) x R, NbPlanes
};

template <int NPROD, int EPI>
__global__ void __launch_bounds__(TC_THREADS, 1)
    tc_tile_kernel(const __grid_constant__ CUtensorMap a_hi_map,
                   const __grid_constant__ CUtensorMap a_lo_map,
                   const __grid_constant__ CUtensorMap b_hi_map,
                   const __grid_constant__ CUtensorMap b_lo_map,
                   const TcOut o, int R, int K, int kpart, int ncols) {
  using C = TcCfg<NPROD>;
  const int row0 = blockIdx.x * TC_BM;
  const int lag0 = blockIdx.y * TILE_N;
  const int t = threadIdx.x;
  const size_t part0 = (size_t)blockIdx.y * R;

  if (EPI == EPI_PEAK) {
    bool needed = false;
    if (t < TC_BM && row0 + t < R) {
      const int b = (o.row_base + row0 + t) / o.bdiv;
      const int l = o.lo[b], h = o.hi[b];
      needed = l <= h && l <= lag0 + TILE_N - 1 && h >= lag0;
    }
    if (!__syncthreads_or(needed)) {
      if (t < TC_BM && row0 + t < R) {
        o.part_val[part0 + row0 + t] = -CUDART_INF_F;
        o.part_idx[part0 + row0 + t] = 0;
      }
      return;
    }
  }
  if (EPI == EPI_PEAK_NB) {
    bool needed = false;
    if (t < TC_BM && row0 + t < R) {
      const int b = (o.row_base + row0 + t) / o.bdiv;
      const int l = o.lo[b], h = o.hi[b];
      needed = l <= h && l - 1 <= lag0 + TILE_N - 1 && h + 1 >= lag0;
    }
    if (!__syncthreads_or(needed)) {
      if (t < TC_BM && row0 + t < R) {
        const NbPlanes nb{o.part_nb, (size_t)gridDim.y * R};
        o.part_val[part0 + row0 + t] = -CUDART_INF_F;
        o.part_idx[part0 + row0 + t] = 0;
#pragma unroll
        for (int k = 0; k < 4; ++k) nb.at(k, part0 + row0 + t) = 0.f;
      }
      return;
    }
  }

  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + C::STAGES * C::STAGE);
  uint64_t* empty = full + C::STAGES;
  if (t == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS);
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int kb0 = blockIdx.z * kpart / TILE_K;
  const int nk = min(K, (int)(blockIdx.z + 1) * kpart) / TILE_K - kb0;
  const int wg = t / WG_THREADS;

  if (wg == CONSUMERS) {  // producer warpgroup: one thread issues every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(PRODUCER_REGS));
    if (t == CONSUMERS * WG_THREADS) {
      int s = 0;
      uint32_t phase = 0;
      for (int kb = 0; kb < nk; ++kb) {
        mbar_wait(&empty[s], phase ^ 1);
        uint8_t* st = smem + s * C::STAGE;
        uint8_t* sb = st + C::PLANES * A_TILE;
        const int k0 = (kb0 + kb) * TILE_K;
        mbar_expect_tx(&full[s], C::STAGE);
        tma_load_2d(st, &a_hi_map, &full[s], k0, row0);
        tma_load_2d(sb, &b_hi_map, &full[s], k0, lag0);
        if (C::PLANES == 2) {
          tma_load_2d(st + A_TILE, &a_lo_map, &full[s], k0, row0);
          tma_load_2d(sb + B_TILE, &b_lo_map, &full[s], k0, lag0);
        }
        if (++s == C::STAGES) {
          s = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // consumer warpgroup wg: rows row0 + 64 wg .. + 63 of the A tiles; each
  // K block's products land in `part`, summed into `acc` in K order with
  // fp32 adds (round to nearest)
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(CONSUMER_REGS));
  float acc[ACC], part[ACC];
#pragma unroll
  for (int i = 0; i < ACC; ++i) acc[i] = 0.f;
  const int a_off = wg * TILE_M * TILE_K * 4;
  const bool lead = t % WG_THREADS == 0;
  int s = 0, pending = -1;  // pending: a stage whose products may be in flight
  uint32_t phase = 0;
  for (int kb = 0; kb < nk; ++kb) {
    mbar_wait(&full[s], phase);
    const uint8_t* st = smem + s * C::STAGE;
    const uint8_t* sb = st + C::PLANES * A_TILE;
    // `part` is touched outside the tensor cores only between a fold and
    // the next group's first products: a fence anywhere else would make
    // the compiler drain the products in flight
    if (kb % C::FOLD == 0) fence_acc(part);
    wgmma_fence();
    tile_kblock<NPROD>(part, st + a_off,
                       st + (C::PLANES == 2 ? A_TILE : 0) + a_off, sb,
                       sb + (C::PLANES == 2 ? B_TILE : 0), kb % C::FOLD != 0);
    wgmma_commit();
    const bool fold = kb % C::FOLD == C::FOLD - 1 || kb == nk - 1;
    if (fold) {
      wgmma_wait<0>();
      fence_acc(part);
    } else {
      wgmma_wait<1>();  // the previous block's products are done
    }
    if (lead && pending >= 0) mbar_arrive(&empty[pending]);
    if (lead && fold) mbar_arrive(&empty[s]);
    pending = fold ? -1 : s;
    if (fold) {
#pragma unroll
      for (int i = 0; i < ACC; ++i) acc[i] += part[i];
    }
    if (++s == C::STAGES) {
      s = 0;
      phase ^= 1;
    }
  }

  const int lane = t & 31, warp = (t % WG_THREADS) / 32;
  const int ra = row0 + wg * TILE_M + warp * 16 + (lane >> 2);
  const int rb = ra + 8;
  if (EPI == EPI_STORE) {
    // register 4j + e (+2 for row b) holds column 8j + 2(lane % 4) + e
    const int q = lane & 3;
    float* out = o.out + (size_t)blockIdx.z * R * o.ldo;
#pragma unroll
    for (int j = 0; j < TILE_N / 8; ++j) {
      const int col = lag0 + 8 * j + 2 * q;
      const float sg = col >= o.neg_from ? -1.f : 1.f;
      if (ra < R)
        *reinterpret_cast<float2*>(out + (size_t)ra * o.ldo + col) =
            make_float2(sg * acc[4 * j], sg * acc[4 * j + 1]);
      if (rb < R)
        *reinterpret_cast<float2*>(out + (size_t)rb * o.ldo + col) =
            make_float2(sg * acc[4 * j + 2], sg * acc[4 * j + 3]);
    }
    return;
  }
  int lo_a = 1, hi_a = 0, lo_b = 1, hi_b = 0;  // empty ranges past R
  if (ra < R) {
    lo_a = o.lo[(o.row_base + ra) / o.bdiv];
    hi_a = o.hi[(o.row_base + ra) / o.bdiv];
  }
  if (rb < R) {
    lo_b = o.lo[(o.row_base + rb) / o.bdiv];
    hi_b = o.hi[(o.row_base + rb) / o.bdiv];
  }
  const TileBest b = tile_first_max(acc, lag0, ncols, lo_a, hi_a, lo_b, hi_b);
  if (EPI == EPI_PEAK_NB) {
    const TileNb n = tile_neighbours(acc, lag0, ncols, b.ia, b.ib);
    const NbPlanes nb{o.part_nb, (size_t)gridDim.y * R};
    const int q = lane & 3;
    if (q == 0) {
      if (ra < R) {
        o.part_val[part0 + ra] = b.va;
        o.part_idx[part0 + ra] = b.ia;
        nb.at(0, part0 + ra) = n.ma;
        nb.at(1, part0 + ra) = n.pa;
        nb.at(2, part0 + ra) = acc[0];
      }
      if (rb < R) {
        o.part_val[part0 + rb] = b.vb;
        o.part_idx[part0 + rb] = b.ib;
        nb.at(0, part0 + rb) = n.mb;
        nb.at(1, part0 + rb) = n.pb;
        nb.at(2, part0 + rb) = acc[2];
      }
    }
    if (q == 3) {  // column lag0 + 127: j = 15, e = 1
      if (ra < R) nb.at(3, part0 + ra) = acc[ACC - 3];
      if (rb < R) nb.at(3, part0 + rb) = acc[ACC - 1];
    }
    return;
  }
  if ((lane & 3) == 0) {
    if (ra < R) {
      o.part_val[part0 + ra] = b.va;
      o.part_idx[part0 + ra] = b.ia;
    }
    if (rb < R) {
      o.part_val[part0 + rb] = b.vb;
      o.part_idx[part0 + rb] = b.ib;
    }
  }
}

// ---- host side: tensor maps and launches ------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, fetched from the driver at run time
// (cudaGetDriverEntryPoint), so that nothing links against libcuda.
inline EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A row-major (rows, K) fp32 matrix, read in boxes of 32 x box_rows.
inline bool encode(EncodeTiled fn, CUtensorMap* map, const float* base,
                   int rows, int K, int box_rows) {
  const cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)K * sizeof(float)};
  const cuuint32_t box[2] = {(cuuint32_t)TILE_K, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2,
            const_cast<float*>(base), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The four tensor maps of A (R, K) and Bt (ncols_p, K), hi and lo planes
// (a plane the products do not read may repeat hi).  Returns 0, -1 (no
// tensor-map encoder) or -2 (a map was refused).
inline int encode_operands(CUtensorMap (&maps)[4], const float* a_hi,
                           const float* a_lo, int R, const float* b_hi,
                           const float* b_lo, int ncols_p, int K) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return -1;
  if (!encode(fn, &maps[0], a_hi, R, K, TC_BM) ||
      !encode(fn, &maps[1], a_lo, R, K, TC_BM) ||
      !encode(fn, &maps[2], b_hi, ncols_p, K, TILE_N) ||
      !encode(fn, &maps[3], b_lo, ncols_p, K, TILE_N))
    return -2;
  return 0;
}

// The tile at NPROD tf32 products a term; K in parts of kpart (EPI_STORE
// only; EPI_PEAK takes kpart = K).
template <int NPROD, int EPI>
int launch_tc_tiles(const CUtensorMap (&maps)[4], const TcOut& o, int R,
                    int K, int kpart, int ncols, cudaStream_t stream) {
  using C = TcCfg<NPROD>;
  // set on every launch: a flag kept in a static of this template would be
  // one object in every library that includes the header (a template's
  // static locals are unique process-wide), while the attribute belongs to
  // each library's own copy of the kernel
  const cudaError_t err = cudaFuncSetAttribute(
      tc_tile_kernel<NPROD, EPI>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      C::SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((R + TC_BM - 1) / TC_BM, (ncols + TILE_N - 1) / TILE_N,
                  (K + kpart - 1) / kpart);
  tc_tile_kernel<NPROD, EPI><<<grid, TC_THREADS, C::SMEM, stream>>>(
      maps[0], maps[1], maps[2], maps[3], o, R, K, kpart, ncols);
  return (int)cudaGetLastError();
}

// The tf32 split of n fp32 values (n a multiple of 4): hi, and lo unless
// it is null.  Returns the cudaError_t of the launch.
inline int launch_split(const float* x, float* hi, float* lo, long long n,
                        cudaStream_t stream) {
  const long long n4 = n / 4;
  const long long blocks = (n4 + 255) / 256 < 132 * 16 ? (n4 + 255) / 256
                                                         : 132 * 16;
  tf32_split_kernel<<<(unsigned)blocks, 256, 0, stream>>>(
      reinterpret_cast<const float4*>(x), reinterpret_cast<float4*>(hi),
      reinterpret_cast<float4*>(lo), n4);
  return (int)cudaGetLastError();
}

}  // namespace nbls
