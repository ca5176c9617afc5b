// icorr_peak for Hopper (sm_90a), the IEEE-fp32 route (matmul_precision
// 'highest'): fused inverse-DFT correlation + masked first-max peak search
// on the CUDA cores.  'high' and 'default' run on the tensor cores
// (xcorr_peak_tc.cu).
//
// Replaces the TPU kernel narrow_band_least_squares_tpu/ops/kernels/
// xcorr_peak.py::icorr_peak (body _peak_kernel, pallas_call at :128).
//
// For every row r of cs2 (R, K2) and lag column l of e2 (K2, nlag):
//     cc[r, l] = sum_k cs2[r, k] * e2[k, l]              (fp32 FMA, k ascending)
//     peak[r]  = max over lo[r] <= l <= hi[r] of cc[r, l]
//     idx[r]   = the FIRST l that reaches it (jnp.argmax tie-break)
// A row with no valid lag gives peak = -inf, idx = 0, as on the TPU.
//
// What bounds it: the fp32 operations.  2*R*K2*nlag FLOPs against
// 4*(R*K2 + K2*nlag) input bytes is hundreds of FLOPs per byte at the
// canonical shapes, so the card's fp32 CUDA-core rate (67 TFLOP/s) is the
// bound, not its memory.  The (R, nlag) correlation never reaches device
// memory, as on the TPU: each CTA computes one 64-row x 128-lag tile of cc
// in registers with the tile of simt_tile.cuh (8 x 8 per thread, two
// shared-memory stages, B copied by cp.async and A by a register prefetch
// stored transposed, four CTAs an SM) and
// reduces it at once to a (max, first argmax) per row.  e2 arrives with its
// lag axis zero-padded to the 128-lag tile and K2 to the 16-wide K chunk,
// built once with the pipeline, so every load is an aligned float4.
//
// The TPU kernel walked lag tiles in order on one core, carrying the running
// best.  Here lag tiles run in parallel CTAs, so each writes its per-row
// partial (max, argmax) to a small scratch buffer, and a second pass folds
// the partials in ascending lag-tile order, replacing the best only on a
// strictly greater value.  Within a tile each thread scans its lags in
// ascending order with a strict compare, and the cross-lane reduction keeps
// the smaller index on equal values, so the result is the first maximum over
// the whole lag range.  No split-K: a row's value does not depend on the
// grid.  Tiles that no row of the CTA searches are skipped.
//
// With sub-sample delays (nbls_icorr_peak_f32_nb) the epilogue also keeps
// the correlations beside each row's maximum, from the same accumulator,
// and each tile's first and last column; the fold patches a neighbour
// that lies in the adjacent tile from that tile's edge column, as the JAX
// package's lag-tiled loop does with its carried columns
// (narrow_band_least_squares_tpu/ops/xcorr.py::cross_correlate_mxu).
//
// Plain C interface, bound from Python with ctypes; built with
//   nvcc -gencode=arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared
// by narrow_band_least_squares_tpu_torch/ops/kernels/_build.py.

#include "peak_tile.cuh"
#include "simt_tile.cuh"

namespace {

using namespace nbls::simt;

constexpr int BK = 16;  // K chunk per shared-memory stage

// NB: also the peak's two neighbouring correlations (first_max_nb_partials)
// into the four planes of part_nb; a tile is then needed where a row's
// [lo - 1, hi + 1] meets it, since a peak at lo or hi takes a neighbour
// from one column past the band.
template <bool NB>
__global__ void __launch_bounds__(NT, MIN_CTAS)
icorr_peak_tile_kernel(const float* __restrict__ cs2,
                       const float* __restrict__ e2p,
                       const int* __restrict__ lo,
                       const int* __restrict__ hi,
                       float* __restrict__ part_val,
                       int* __restrict__ part_idx,
                       float* __restrict__ part_nb,
                       int R, int K2, int nlag, int nlag_p) {
  const int row0 = blockIdx.x * BM;
  const int lag0 = blockIdx.y * BN;
  float* pv = part_val + (size_t)blockIdx.y * R;
  int* pi = part_idx + (size_t)blockIdx.y * R;
  const size_t plane = (size_t)gridDim.y * R;
  const auto bounds = [&](int r, int& l, int& h) {
    l = lo[r];
    h = hi[r];
  };
  const auto grown = [&](int r, int& l, int& h) {
    l = lo[r];
    h = hi[r];
    if (l <= h) {
      --l;
      ++h;
    }
  };
  const bool needed = NB ? tile_needed(row0, lag0, R, grown)
                         : tile_needed(row0, lag0, R, bounds);
  if (!needed) {
    skip_partials(row0, R, pv, pi);
    if (NB && threadIdx.x < BM && row0 + threadIdx.x < R)
      for (int k = 0; k < 4; ++k)
        part_nb[k * plane + (size_t)blockIdx.y * R + row0 + threadIdx.x] = 0.f;
    return;
  }
  __shared__ __align__(16) Smem<BK> s;
  float acc[TM][TN];
  mainloop<BK>(s, RowsA<BK>(cs2, row0, R, K2), RowsB{e2p + lag0, nlag_p, K2},
               0, K2 / BK, acc);
  if (NB)
    first_max_nb_partials(acc, row0, lag0, R, nlag, bounds, pv, pi,
                          part_nb + (size_t)blockIdx.y * R, plane);
  else
    first_max_partials(acc, row0, lag0, R, nlag, bounds, pv, pi);
}

}  // namespace

extern "C" {

// Lags per CTA: e2's lag axis is padded to a multiple of it, and the scratch
// buffers hold nlag_p / lag_tile x R partials.
int nbls_icorr_peak_lag_tile(void) { return BN; }

// K chunk: cs2's and e2's K2 is a multiple of it.
int nbls_icorr_peak_k_chunk(void) { return BK; }

// Launches both passes on `stream`; returns the cudaError_t of the launches
// (0 on success).  cs2 (R, K2) and e2p (K2, nlag_p): K2 a multiple of the K
// chunk, nlag_p of the lag tile, zero past nlag; both 16-byte aligned.
// part_val / part_idx: scratch of nlag_p / lag_tile * R each.
int nbls_icorr_peak_f32(const float* cs2, const float* e2p, const int* lo,
                        const int* hi, float* peak, int* idx, float* part_val,
                        int* part_idx, int R, int K2, int nlag, int nlag_p,
                        cudaStream_t stream) {
  if (R <= 0 || nlag <= 0 || K2 <= 0 || K2 % BK != 0 || nlag_p % BN != 0 ||
      nlag_p < nlag)
    return (int)cudaErrorInvalidValue;
  const int ntiles = nlag_p / BN;
  const dim3 grid((R + BM - 1) / BM, ntiles);
  icorr_peak_tile_kernel<false><<<grid, NT, 0, stream>>>(
      cs2, e2p, lo, hi, part_val, part_idx, nullptr, R, K2, nlag, nlag_p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  nbls::peak_merge_kernel<<<(R + 255) / 256, 256, 0, stream>>>(
      part_val, part_idx, peak, idx, R, ntiles);
  return (int)cudaGetLastError();
}

// nbls_icorr_peak_f32, and per row the correlations at idx - 1 and idx + 1
// into cm / cp (0 where idx is 0, nlag - 1 or the row has no valid lag).
// part_nb: scratch of 4 x nlag_p / lag_tile x R.
int nbls_icorr_peak_f32_nb(const float* cs2, const float* e2p, const int* lo,
                           const int* hi, float* peak, int* idx, float* cm,
                           float* cp, float* part_val, int* part_idx,
                           float* part_nb, int R, int K2, int nlag, int nlag_p,
                           cudaStream_t stream) {
  if (R <= 0 || nlag <= 0 || K2 <= 0 || K2 % BK != 0 || nlag_p % BN != 0 ||
      nlag_p < nlag)
    return (int)cudaErrorInvalidValue;
  const int ntiles = nlag_p / BN;
  const dim3 grid((R + BM - 1) / BM, ntiles);
  icorr_peak_tile_kernel<true><<<grid, NT, 0, stream>>>(
      cs2, e2p, lo, hi, part_val, part_idx, part_nb, R, K2, nlag, nlag_p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  nbls::peak_merge_nb_kernel<<<(R + 255) / 256, 256, 0, stream>>>(
      part_val, part_idx, part_nb, peak, idx, cm, cp, R, ntiles, BN);
  return (int)cudaGetLastError();
}

}  // extern "C"
