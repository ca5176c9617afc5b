// icorr_peak for Hopper (sm_90a): fused inverse-DFT correlation + masked
// first-max peak search.
//
// Replaces the TPU kernel narrow_band_least_squares_tpu/ops/kernels/
// xcorr_peak.py::icorr_peak (body _peak_kernel, pallas_call at :128).
//
// For every row r of cs2 (R, K2) and lag column l of e2 (K2, nlag):
//     cc[r, l] = sum_k cs2[r, k] * e2[k, l]              (fp32 FMA)
//     peak[r]  = max over lo[r] <= l <= hi[r] of cc[r, l]
//     idx[r]   = the FIRST l that reaches it (jnp.argmax tie-break)
// A row with no valid lag gives peak = -inf, idx = 0, as on the TPU.
//
// What bounds it: the fp32 operations.  2*R*K2*nlag FLOPs against
// 4*(R*K2 + K2*nlag) input bytes is hundreds of FLOPs per byte at the
// canonical shapes, so the card's fp32 CUDA-core rate is the bound, not its
// memory.  The design keeps the (R, nlag) correlation out of device memory,
// as the TPU kernel did: each CTA computes one 128-row x 64-lag tile of cc in
// registers (register-blocked 8x4 per thread, K streamed through shared
// memory in chunks of 16) and reduces it at once to a (max, argmax) per row.
//
// The TPU kernel walked lag tiles in order on one core, carrying the running
// best.  Here lag tiles run in parallel CTAs (a row tile alone gives too few
// CTAs to fill 132 SMs), so each writes its per-row partial (max, argmax) to
// a small scratch buffer, and a second pass folds the partials in ascending
// lag-tile order, replacing the best only on a strictly greater value.
// Within a tile, each thread scans its lags in ascending order with a strict
// compare, and the cross-lane reduction keeps the smaller index on equal
// values, so the result is the first maximum over the whole lag range.
// Tiles that no row of the CTA searches (outside every [lo, hi]) are skipped.
//
// Plain C interface, bound from Python with ctypes; built with
//   nvcc -gencode=arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared
// by narrow_band_least_squares_tpu_torch/ops/kernels/_build.py.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int BM = 128;  // rows per CTA
constexpr int BN = 64;   // lags per CTA (one lag tile)
constexpr int BK = 16;   // K chunk staged in shared memory
constexpr int TM = 8;    // rows per thread
constexpr int TN = 4;    // lags per thread
constexpr int NT = (BM / TM) * (BN / TN);  // 256 threads
constexpr int LANES_PER_ROW = BN / TN;     // 16 lanes share one row group

static_assert(LANES_PER_ROW == 16, "the shuffle reduction assumes 16 lanes");

__global__ void __launch_bounds__(NT)
icorr_peak_tile_kernel(const float* __restrict__ cs2,
                       const float* __restrict__ e2,
                       const int* __restrict__ lo,
                       const int* __restrict__ hi,
                       float* __restrict__ part_val,
                       int* __restrict__ part_idx,
                       int R, int K2, int nlag) {
  const int row0 = blockIdx.x * BM;
  const int lag0 = blockIdx.y * BN;
  const int t = threadIdx.x;
  const int tx = t % LANES_PER_ROW;  // lag group: lags lag0 + tx*TN ...
  const int ty = t / LANES_PER_ROW;  // row group: rows row0 + ty*TM ...
  const size_t part0 = (size_t)blockIdx.y * R;

  bool needed = false;
  if (t < BM && row0 + t < R) {
    const int l = lo[row0 + t], h = hi[row0 + t];
    needed = l <= h && l <= lag0 + BN - 1 && h >= lag0;
  }
  if (!__syncthreads_or(needed)) {
    if (t < BM && row0 + t < R) {
      part_val[part0 + row0 + t] = -CUDART_INF_F;
      part_idx[part0 + row0 + t] = 0;
    }
    return;
  }

  __shared__ __align__(16) float As[BK][BM + 4];  // cs2 chunk, transposed
  __shared__ __align__(16) float Bs[BK][BN];      // e2 chunk

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K2; k0 += BK) {
#pragma unroll
    for (int i = 0; i < (BM * BK) / NT; ++i) {
      const int e = t + i * NT;
      const int r = e / BK, k = e % BK;
      const int gr = row0 + r, gk = k0 + k;
      As[k][r] = (gr < R && gk < K2) ? cs2[(size_t)gr * K2 + gk] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < (BK * BN) / NT; ++i) {
      const int e = t + i * NT;
      const int k = e / BN, c = e % BN;
      const int gk = k0 + k, gc = lag0 + c;
      Bs[k][c] = (gk < K2 && gc < nlag) ? e2[(size_t)gk * nlag + gc] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[k][ty * TM]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[k][ty * TM + 4]);
      const float4 b = *reinterpret_cast<const float4*>(&Bs[k][tx * TN]);
      const float a[TM] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[TN] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = row0 + ty * TM + i;
    int rlo = 1, rhi = 0;  // empty range for rows past R
    if (r < R) {
      rlo = lo[r];
      rhi = hi[r];
    }
    float best = -CUDART_INF_F;
    int bidx = 0;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int col = lag0 + tx * TN + j;
      if (col >= rlo && col <= rhi && col < nlag && acc[i][j] > best) {
        best = acc[i][j];
        bidx = col;
      }
    }
#pragma unroll
    for (int off = LANES_PER_ROW / 2; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, best, off);
      const int oi = __shfl_xor_sync(0xffffffffu, bidx, off);
      if (ov > best || (ov == best && oi < bidx)) {
        best = ov;
        bidx = oi;
      }
    }
    if (tx == 0 && r < R) {
      part_val[part0 + r] = best;
      part_idx[part0 + r] = bidx;
    }
  }
}

__global__ void icorr_peak_merge_kernel(const float* __restrict__ part_val,
                                        const int* __restrict__ part_idx,
                                        float* __restrict__ peak,
                                        int* __restrict__ idx, int R,
                                        int ntiles) {
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

}  // namespace

extern "C" {

// Lags per CTA: the scratch buffers hold ceil(nlag / lag_tile) x R partials.
int nbls_icorr_peak_lag_tile(void) { return BN; }

// Launches both passes on `stream`; returns the cudaError_t of the launches
// (0 on success).  part_val / part_idx: scratch of ceil(nlag/BN) * R each.
int nbls_icorr_peak_f32(const float* cs2, const float* e2, const int* lo,
                        const int* hi, float* peak, int* idx, float* part_val,
                        int* part_idx, int R, int K2, int nlag,
                        cudaStream_t stream) {
  if (R <= 0 || nlag <= 0) return (int)cudaErrorInvalidValue;
  const int ntiles = (nlag + BN - 1) / BN;
  const dim3 grid((R + BM - 1) / BM, ntiles);
  icorr_peak_tile_kernel<<<grid, NT, 0, stream>>>(cs2, e2, lo, hi, part_val,
                                                  part_idx, R, K2, nlag);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  icorr_peak_merge_kernel<<<(R + 255) / 256, 256, 0, stream>>>(
      part_val, part_idx, peak, idx, R, ntiles);
  return (int)cudaGetLastError();
}

}  // extern "C"
