// fused_xcorr_bucket for Hopper (sm_90a): the whole delay search of one
// window-length bucket, from the filtered band rows to (rho, lag index).
//
// Replaces the TPU kernel narrow_band_least_squares_tpu/ops/kernels/
// fused_xcorr.py::fused_xcorr_bucket (body _fused_kernel, pallas_call at
// :245).  For band row g of y (Bg, C, T), window w < W and pair p = (i, j):
//     start   = min(w * hop[g], maxstart[g])
//     win     = (y[g, :, start:start+Lg] * lm - mean) * lm   (y zero past T)
//     E[c]    = sum_t win[c, t]^2
//     F[c, k] = sum_t win[c, t] Cf[t, k] - i sum_t win[c, t] Sf[t, k]
//     CS      = F[j] * conj(F[i])
//     cc[l]   = sum_k Re CS[k] Ec[k, l] - Im CS[k] Es[k, l]
//     idx     = the FIRST l in [lo[g], hi[g]] reaching max cc (jnp.argmax)
//     rho     = max cc / sqrt(E[i] E[j])  (0 where the denominator is 0)
// All in IEEE fp32 (FMA) on the CUDA cores, whatever matmul precision the
// caller names.
//
// What bounds it: the fp32 operations.  The inverse DFT, 2 P 2K nlag FLOPs
// per window, is about seven times the forward DFT at the canonical shapes;
// together they are hundreds of FLOPs per byte of the band rows and tables,
// so the bound is the card's fp32 CUDA-core rate (67 TFLOP/s), not memory.
//
// Design.  The TPU kernel keeps a window tile's whole (Wt*P, nlag)
// correlation in VMEM and walks the K tiles in order.  A Hopper block has
// 227 KB of shared memory, less than one window's (P, nlag) correlation at
// the canonical shapes, and a bucket holds too few windows to fill 132 SMs,
// so the lag axis is split across blocks.  Splitting it would make every
// lag block recompute the window's forward DFT; instead the launch runs
// four passes on one stream:
//   1. window_stats: per (g, w, c), the mean and energy of the masked
//      window (one warp each).
//   2. spectra: F for every (g, w, c) as a tiled product of the windows
//      (extracted, masked and demeaned as they are loaded) with [Cf | Sf],
//      into a scratch of 2 Kp floats per row.  A bucket has only a few
//      hundred (g, w, c) rows, so the window axis is split in SPLIT parts
//      across blocks for parallelism, and spectra_sum adds the parts in a
//      fixed order (no atomics: every run gives the same bits).  The
//      spectra are twice the window's size and stay in L2; the windows
//      themselves never reach device memory.
//   3. xcorr_tile: one block per (128 rows of (g, w, p), 64 lags).  Per K
//      chunk it stages the spectra of the few windows its rows span in
//      shared memory, forms its rows' cross-spectra from them by the pair
//      indices (the TPU kernel's block-diagonal one-hot matmuls become index
//      reads), accumulates the 128 x 64 correlation tile in registers over
//      K, and reduces it at once to a per-row (max, first argmax) within
//      [lo, hi].  Neither the cross-spectra nor the correlation reach
//      device memory.  A tile no row of the block searches is skipped.
//   4. merge: per row, fold the lag tiles' partials in ascending order,
//      replacing only on a strictly greater value (the first maximum wins,
//      as in jnp.argmax), and divide by sqrt(E[i] E[j]).
// Every row's arithmetic is fixed by its own (g, w, p) and the tables, not
// by how many rows share the launch, so merging arrays into one launch
// changes no bit of any row.
//
// Limits: sizes whose flat offsets need more than 32 bits (Bg*C*T,
// SPLIT*Bg*W*C*2*Kp, ceil(nlag/64)*Bg*W*P at 2^31 or more), and element
// counts whose staged spectra, ((127/P + 2) * C) rows of 128 bytes, do not
// fit a block's shared memory beside the tiles (C above 802), are refused
// by the Python wrapper with a ValueError.  Window length is not limited:
// the window is streamed through shared memory in chunks of 16 samples.
//
// Plain C interface, bound from Python with ctypes; built with
//   nvcc -gencode=arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared
// by narrow_band_least_squares_tpu_torch/ops/kernels/_build.py.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int BM = 128;  // rows per block
constexpr int BN = 64;   // columns (spectra) or lags (xcorr) per block
constexpr int BK = 16;   // reduction chunk staged in shared memory
constexpr int TM = 8;    // rows per thread
constexpr int TN = 4;    // columns per thread
constexpr int NT = (BM / TM) * (BN / TN);  // 256 threads
constexpr int LANES_PER_ROW = BN / TN;     // 16 lanes share one row group
constexpr int SPLIT = 4;  // parts of the window axis in the spectra pass
constexpr int XCORR_STATIC_SMEM = (2 * BK * (BM + 4) + 2 * BK * BN) * 4 + 4 * BM * 4;
constexpr int MAX_SMEM = 232448;  // a block's shared memory on sm_90

static_assert(LANES_PER_ROW == 16, "the shuffle reduction assumes 16 lanes");
static_assert(NT == 256, "the tile loaders assume 256 threads");

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// ---- pass 1: mean and energy of every (g, w, c) window -------------------
__global__ void window_stats_kernel(const float* __restrict__ y,
                                    const int* __restrict__ hop,
                                    const int* __restrict__ maxstart,
                                    const float* __restrict__ len_mask,
                                    float* __restrict__ mean,
                                    float* __restrict__ energy, int Bg, int C,
                                    int T, int Lg, int W) {
  const int row = (int)((blockIdx.x * (size_t)blockDim.x + threadIdx.x) >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= Bg * W * C) return;
  const int c = row % C;
  const int gw = row / C;
  const int w = gw % W, g = gw / W;
  const int start = min(w * hop[g], maxstart[g]);
  const float* yr = y + ((size_t)g * C + c) * T;
  const float* lm = len_mask + (size_t)g * Lg;
  float s = 0.f, n = 0.f;
  for (int t = lane; t < Lg; t += 32) {
    const int ti = start + t;
    const float v = (ti >= 0 && ti < T) ? yr[ti] : 0.f;
    s += __fmul_rn(v, lm[t]);
    n += lm[t];
  }
  s = warp_sum(s);
  n = warp_sum(n);
  const float mu = s / n;
  float e = 0.f;
  for (int t = lane; t < Lg; t += 32) {
    const int ti = start + t;
    const float v = (ti >= 0 && ti < T) ? yr[ti] : 0.f;
    const float x = __fmul_rn(__fsub_rn(__fmul_rn(v, lm[t]), mu), lm[t]);
    e = fmaf(x, x, e);
  }
  e = warp_sum(e);
  if (lane == 0) {
    mean[row] = mu;
    energy[row] = e;
  }
}

// ---- pass 2: spectra F = win @ [Cf | -Sf] for every (g, w, c) row ---------
// Part z of spec (z < SPLIT) sums the window samples [z*Lc, (z+1)*Lc); its
// row r = (g*W + w)*C + c holds Re F in [0, Kp) and Im F in [Kp, 2Kp).
__global__ void __launch_bounds__(NT)
spectra_tile_kernel(const float* __restrict__ y, const int* __restrict__ hop,
                    const int* __restrict__ maxstart,
                    const float* __restrict__ len_mask,
                    const float* __restrict__ mean,
                    const float* __restrict__ Cf, const float* __restrict__ Sf,
                    float* __restrict__ spec, int Bg, int C, int T, int Lg,
                    int W, int Kp) {
  const int M = Bg * W * C;
  const int N = 2 * Kp;
  const int row0 = blockIdx.x * BM;
  const int col0 = blockIdx.y * BN;
  const int Lc = (Lg + SPLIT * BK - 1) / (SPLIT * BK) * BK;
  const int tbeg = blockIdx.z * Lc;
  const int tend = min(Lg, tbeg + Lc);
  spec += (size_t)blockIdx.z * M * N;
  const int t = threadIdx.x;
  const int tx = t % LANES_PER_ROW;
  const int ty = t / LANES_PER_ROW;

  __shared__ __align__(16) float As[BK][BM + 4];  // windows chunk, transposed
  __shared__ __align__(16) float Bs[BK][BN];      // table chunk
  __shared__ int rBase[BM];   // offset of the row's (g, c) trace in y
  __shared__ int rStart[BM];  // the window's first sample in that trace
  __shared__ int rG[BM];      // band row
  __shared__ float rMean[BM];

  if (t < BM) {
    const int r = row0 + t;
    if (r < M) {
      const int c = r % C, gw = r / C;
      const int w = gw % W, g = gw / W;
      const int start = min(w * hop[g], maxstart[g]);
      rBase[t] = (g * C + c) * T;
      rStart[t] = start;
      rG[t] = g;
      rMean[t] = mean[r];
    } else {
      rBase[t] = 0;
      rStart[t] = 0;
      rG[t] = -1;
      rMean[t] = 0.f;
    }
  }
  __syncthreads();

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = tbeg; k0 < tend; k0 += BK) {
#pragma unroll
    for (int i = 0; i < (BM * BK) / NT; ++i) {
      const int e = t + i * NT;
      const int r = e / BK, k = e % BK;
      const int ts = k0 + k;
      float a = 0.f;
      if (rG[r] >= 0 && ts < tend) {
        const float lm = len_mask[(size_t)rG[r] * Lg + ts];
        const int ti = rStart[r] + ts;
        const float v = (ti >= 0 && ti < T) ? y[(size_t)rBase[r] + ti] : 0.f;
        a = __fmul_rn(__fsub_rn(__fmul_rn(v, lm), rMean[r]), lm);
      }
      As[k][r] = a;
    }
#pragma unroll
    for (int i = 0; i < (BK * BN) / NT; ++i) {
      const int e = t + i * NT;
      const int k = e / BN, c = e % BN;
      const int ts = k0 + k, gc = col0 + c;
      float b = 0.f;
      if (ts < tend && gc < N)
        b = gc < Kp ? Cf[(size_t)ts * Kp + gc] : Sf[(size_t)ts * Kp + gc - Kp];
      Bs[k][c] = b;
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
    if (r >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int col = col0 + tx * TN + j;
      if (col < N) spec[(size_t)r * N + col] = col < Kp ? acc[i][j] : -acc[i][j];
    }
  }
}

// Adds the SPLIT parts of the spectra into part 0, in a fixed order.
__global__ void spectra_sum_kernel(float* __restrict__ spec, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float v = spec[i];
#pragma unroll
  for (int z = 1; z < SPLIT; ++z) v = __fadd_rn(v, spec[(size_t)z * n + i]);
  spec[i] = v;
}

// Spectra rows (g*W + w)*C + c that the 128 rows of one xcorr block can
// span: their windows are at most (BM - 1) / P + 2.
__host__ __device__ inline int staged_rows(int C, int P) {
  return ((BM - 1) / P + 2) * C;
}

// ---- pass 3: cross-spectra + inverse DFT + per-tile masked first-max ------
__global__ void __launch_bounds__(NT)
xcorr_tile_kernel(const float* __restrict__ spec, const int* __restrict__ pairs,
                  const int* __restrict__ lo, const int* __restrict__ hi,
                  const float* __restrict__ Ec, const float* __restrict__ Es,
                  float* __restrict__ part_val, int* __restrict__ part_idx,
                  int Bg, int C, int W, int P, int Kp, int nlag) {
  const int R = Bg * W * P;
  const int K2 = 2 * Kp;
  const int row0 = blockIdx.x * BM;
  const int lag0 = blockIdx.y * BN;
  const int t = threadIdx.x;
  const int tx = t % LANES_PER_ROW;
  const int ty = t / LANES_PER_ROW;
  const size_t part0 = (size_t)blockIdx.y * R;

  __shared__ __align__(16) float As[2 * BK][BM + 4];  // [Re CS ; -Im CS] chunk
  __shared__ __align__(16) float Bs[2 * BK][BN];      // [Ec ; Es] chunk
  __shared__ int rI[BM];  // staged spectra rows of the pair's channels i, j
  __shared__ int rJ[BM];
  __shared__ int rLo[BM];
  __shared__ int rHi[BM];
  extern __shared__ float Ss[];  // [staged rows][Re F chunk, Im F chunk]

  // the spectra rows of the windows gw0..gw1 that this block's rows use
  const int gw0 = row0 / P;
  const int srow0 = gw0 * C;
  const int nsrows = (min(R - 1, row0 + BM - 1) / P - gw0 + 1) * C;

  bool needed = false;
  if (t < BM) {
    const int r = row0 + t;
    if (r < R) {
      const int p = r % P, gw = r / P, g = gw / W;
      rI[t] = (gw - gw0) * C + pairs[2 * p];
      rJ[t] = (gw - gw0) * C + pairs[2 * p + 1];
      rLo[t] = lo[g];
      rHi[t] = hi[g];
      needed = rLo[t] <= rHi[t] && rLo[t] <= lag0 + BN - 1 && rHi[t] >= lag0;
    } else {
      rI[t] = rJ[t] = 0;
      rLo[t] = 1;  // empty range for rows past R
      rHi[t] = 0;
    }
  }
  if (!__syncthreads_or(needed)) {
    if (t < BM && row0 + t < R) {
      part_val[part0 + row0 + t] = -CUDART_INF_F;
      part_idx[part0 + row0 + t] = 0;
    }
    return;
  }

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < Kp; k0 += BK) {
    for (int e = t; e < nsrows * 2 * BK; e += NT) {
      const int sr = e / (2 * BK), q = e % (2 * BK);
      const int gk = k0 + q % BK;
      Ss[e] = gk < Kp ? spec[(size_t)(srow0 + sr) * K2 + (q / BK) * Kp + gk] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < (2 * BK * BN) / NT; ++i) {
      const int e = t + i * NT;
      const int k2 = e / BN, c = e % BN;
      const int gk = k0 + (k2 % BK), gc = lag0 + c;
      float b = 0.f;
      if (gk < Kp && gc < nlag)
        b = (k2 < BK ? Ec : Es)[(size_t)gk * nlag + gc];
      Bs[k2][c] = b;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < (BM * BK) / NT; ++i) {
      const int e = t + i * NT;
      const int r = e / BK, k = e % BK;
      float re = 0.f, im = 0.f;
      if (row0 + r < R) {
        const float* si = Ss + rI[r] * 2 * BK;
        const float* sj = Ss + rJ[r] * 2 * BK;
        const float reI = si[k], imI = si[BK + k], reJ = sj[k], imJ = sj[BK + k];
        re = __fadd_rn(__fmul_rn(reJ, reI), __fmul_rn(imJ, imI));
        im = __fsub_rn(__fmul_rn(imJ, reI), __fmul_rn(reJ, imI));
      }
      As[k][r] = re;
      As[BK + k][r] = -im;  // with Es: -Im CS * Es, exactly Im CS * (-Es)
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < 2 * BK; ++k) {
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
    const int rl = ty * TM + i;
    const int r = row0 + rl;
    const int rlo = rLo[rl], rhi = rHi[rl];
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

// ---- pass 4: fold the lag tiles in order, rho = peak / sqrt(Ei Ej) --------
__global__ void merge_kernel(const float* __restrict__ part_val,
                             const int* __restrict__ part_idx,
                             const float* __restrict__ energy,
                             const int* __restrict__ pairs,
                             float* __restrict__ rho, int* __restrict__ idx,
                             int R, int C, int P, int ntiles) {
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
  const int p = r % P, gw = r / P;
  const float ei = energy[gw * C + pairs[2 * p]];
  const float ej = energy[gw * C + pairs[2 * p + 1]];
  const float denom = sqrtf(__fmul_rn(ei, ej));
  rho[r] = denom > 0.f ? __fdiv_rn(best, denom) : 0.f;
  idx[r] = bidx;
}

}  // namespace

extern "C" {

// Lags per xcorr block: the partial buffers hold ceil(nlag / lag_tile) * R.
int nbls_fused_xcorr_lag_tile(void) { return BN; }

// Parts of the spectra scratch: it holds split * Bg*W*C * 2*Kp floats.
int nbls_fused_xcorr_split(void) { return SPLIT; }

// 1 if C elements with P pairs fit the xcorr block's shared memory.
int nbls_fused_xcorr_fits(int C, int P) {
  return XCORR_STATIC_SMEM + (size_t)staged_rows(C, P) * 2 * BK * 4 <= MAX_SMEM;
}

// Launches the four passes on `stream`; returns the cudaError_t of the
// launches (0 on success).  Scratch, allocated by the caller:
//   mean, energy: Bg*W*C floats each; spec: SPLIT*Bg*W*C*2*Kp floats;
//   part_val, part_idx: ceil(nlag/BN) * Bg*W*P each.
int nbls_fused_xcorr_f32(const float* y, const int* hop, const int* maxstart,
                         const int* lo, const int* hi, const float* len_mask,
                         const float* Cf, const float* Sf, const float* Ec,
                         const float* Es, const int* pairs, float* rho,
                         int* idx, float* mean, float* energy, float* spec,
                         float* part_val, int* part_idx, int Bg, int C, int T,
                         int Lg, int W, int Kp, int nlag, int P,
                         cudaStream_t stream) {
  if (Bg <= 0 || C <= 0 || T <= 0 || Lg <= 0 || W <= 0 || Kp <= 0 ||
      nlag <= 0 || P <= 0 || !nbls_fused_xcorr_fits(C, P))
    return (int)cudaErrorInvalidValue;
  const int rowsC = Bg * W * C;
  const int R = Bg * W * P;
  const int ntiles = (nlag + BN - 1) / BN;

  window_stats_kernel<<<(rowsC + 7) / 8, 256, 0, stream>>>(
      y, hop, maxstart, len_mask, mean, energy, Bg, C, T, Lg, W);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const dim3 sgrid((rowsC + BM - 1) / BM, (2 * Kp + BN - 1) / BN, SPLIT);
  spectra_tile_kernel<<<sgrid, NT, 0, stream>>>(
      y, hop, maxstart, len_mask, mean, Cf, Sf, spec, Bg, C, T, Lg, W, Kp);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int nspec = rowsC * 2 * Kp;
  spectra_sum_kernel<<<(nspec + 255) / 256, 256, 0, stream>>>(spec, nspec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const int smem = staged_rows(C, P) * 2 * BK * 4;
  if (smem + XCORR_STATIC_SMEM > 48 * 1024) {
    err = cudaFuncSetAttribute(xcorr_tile_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 xgrid((R + BM - 1) / BM, ntiles);
  xcorr_tile_kernel<<<xgrid, NT, smem, stream>>>(
      spec, pairs, lo, hi, Ec, Es, part_val, part_idx, Bg, C, W, P, Kp, nlag);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  merge_kernel<<<(R + 255) / 256, 256, 0, stream>>>(
      part_val, part_idx, energy, pairs, rho, idx, R, C, P, ntiles);
  return (int)cudaGetLastError();
}

}  // extern "C"
