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
//     in-order fold of per-lag-tile partials.
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
// products of the split (3: lo.hi + hi.lo + hi.hi; 1: hi.hi), the small
// terms first.  a_hi/a_lo/b_hi/b_lo point at 1024-aligned tiles.
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

}  // namespace nbls
