// fused_xcorr_bucket for Hopper (sm_90a): the whole delay search of one
// window-length bucket, from the filtered band rows to (rho, lag index).
//
// Replaces the TPU kernel narrow_band_least_squares_tpu/ops/kernels/
// fused_xcorr.py::fused_xcorr_bucket (body _fused_kernel, pallas_call at
// :245, split-precision dot _kdot at :57).  For band row g of y (Bg, C, T),
// window w < W and pair p = (i, j):
//     start   = min(w * hop[g], maxstart[g])
//     win     = (y[g, :, start:start+Lg] * lm - mean) * lm   (y zero past T)
//     E[c]    = sum_t win[c, t]^2
//     F[c, k] = sum_t win[c, t] Cf[t, k] - i sum_t win[c, t] Sf[t, k]
//     CS      = F[j] * conj(F[i])
//     cc[l]   = sum_k Re CS[k] Ec[k, l] - Im CS[k] Es[k, l]
//     idx     = the FIRST l in [lo[g], hi[g]] reaching max cc (jnp.argmax)
//     rho     = max cc / sqrt(E[i] E[j])  (0 where the denominator is 0)
// The two products (forward DFT, inverse DFT) run at the caller's matmul
// precision, as the TPU kernel's _kdot does: nprod 0 is IEEE fp32 on the
// CUDA cores ('highest'); on the tensor cores nprod 3 is 3xTF32 ('high')
// and nprod 1 ('default') one tf32 pass in both products.  Window
// statistics and cross-spectra are formed in fp32 at every precision.  At
// 'default' the inverse DFT takes the cross-spectra rounded to tf32: each
// is a product of long sums, so its rounding follows their last bits, and a
// plain version that sums in another order agrees with this kernel only to
// that rounding (chip_smoke.py states the tolerance it is held to).
//
// What bounds it: the operations.  The inverse DFT, 2 P 2K nlag FLOPs per
// window, is about seven times the forward DFT at the canonical shapes;
// together they are hundreds of FLOPs per byte of the band rows and
// tables, so the bound is the fp32 CUDA-core rate (67 TFLOP/s) at
// 'highest' and the tf32 tensor-core rate (495 TFLOP/s, three products a
// term at 'high') otherwise, not memory.
//
// Design.  The TPU kernel keeps a window tile's whole (Wt*P, nlag)
// correlation in VMEM and walks the K tiles in order.  A Hopper block has
// 227 KB of shared memory, less than one window's (P, nlag) correlation at
// the canonical shapes, and a bucket holds too few windows to fill 132 SMs,
// so the lag axis is split across blocks, and the forward DFT, which every
// lag block would otherwise recompute, is its own product.  Per launch, on
// one stream, the same passes at every precision, each product on the fp32
// ring tile of simt_ring.cuh ('highest') or the tensor-core tile of
// peak_tile.cuh ('high', 'default'):
//   1. window_stats: per (g, w, c), the mean and energy of the masked
//      window (one warp each).
//   2. windows: the masked, demeaned windows into an L2-resident scratch of
//      (windows of the chunk)*C x Lgp floats (Lg rounded up to 32, zeros
//      past Lg): fp32 and K-major, Lgp rows of the chunk's (g, w, c) rows,
//      as the ring tile reads A ('highest'), or row-major tf32 hi (and lo
//      at 'high') planes.
//   3. forward DFT: the spectra F = win @ [Cf | -Sf], 2 Kp floats a (g, w,
//      c) row, Re F then Im F.  A bucket has only a few hundred such rows,
//      so the samples are split in KSPLIT parts (4 on the fp32 tile, 3 on
//      the tensor cores: a wave each on the canonical buckets), added in a
//      fixed order: every run gives the same bits.  At 'highest' the parts
//      are the CTAs of one cluster, added on chip, and the spectra are
//      stored K-major; on the tensor cores each part is stored and
//      spectra_sum adds them.  The tensor cores take [Cf | Sf]^T, split
//      once per bucket with the pipeline.
//   4. cross-spectra: [Re CS | -Im CS] of every (g, w, p) row, 2 Kp floats,
//      fp32 and K-major ('highest'), tf32 hi and lo planes ('high') or the
//      hi plane ('default'), into an L2-resident scratch.
//   5. inverse DFT and masked first-max, one block per (rows of (g, w, p),
//      128 lags), against [Ec ; Es] (or its split transpose): each block
//      reduces its tile at once to a per-row (max, first argmax) within
//      [lo, hi]; the correlation never reaches device memory.  A tile no
//      row of the block searches is skipped.  At 'highest' the 2 Kp terms
//      are split in kpart_inv parts, the CTAs of one cluster (2: the Ec and
//      the Es half), added on chip in order before the first-max, and the
//      rows of Ec and Es past the Lg + 1 frequencies, zero, are skipped.
//   6. merge: per row, fold the lag tiles' partials in ascending order,
//      replacing only on a strictly greater value (the first maximum wins,
//      as in jnp.argmax), and divide by sqrt(E[i] E[j]).
// The windows and cross-spectra pass through scratch instead of being
// formed on their way to shared memory: on the fp32 tile before the ring
// tile a loader that formed them waited for its loads before the math
// (xcorr 2.87 ms per canonical step against 2.25 ms for the same tile on a
// stored matrix, H100 80GB HBM3 at 700 W), and TMA loads need a stored
// operand.  Forming the split cross-spectra in shared memory inside the
// tensor-core producer warpgroup, so that they never reach device memory,
// is left for later.
// The passes run over the band rows' windows, flat index gw = g * W + w, in
// chunks of gw_chunk (the caller's choice): each pass's scratch holds one
// chunk, so it stays bounded however many windows and pairs a bucket has
// (the cross-spectra alone are P * 2 Kp floats a window, P quadratic in the
// elements).  The canonical and 50-band buckets fit one chunk.
// No part count depends on the number of rows: every output is a K-ordered
// sum fixed by its own (g, w, c) or (g, w, p) and the tables, not by how
// many rows share the launch or the chunk, so merging arrays into one launch
// changes no bit of any row.
// Measured ('highest', H100 80GB HBM3 at 700 W, PERF.md): 2.88 ms a
// canonical step against a 1.28 ms bound (2.93 before the ring tile), 14.66
// ms a 50-band step against 8.11 ms (15.63); the inverse's FMAs run at
// about two thirds of the fp32 rate on every tile shape tried, and a part
// plan of 4 loses to 2 where the card is full (4-CTA clusters fit 496
// CTAs, 2-CTA ones 528).
//
// Limits: the band rows, the rows of rho and one window's scratch must have
// 32-bit flat offsets; the Python wrapper refuses other sizes with a
// ValueError that names the shape.  Shared memory does not depend on the
// shapes (48 KB for the fp32 ring tile, 160 KB for the tensor-core tile),
// so the element count and window length are not otherwise limited.  Kp and the
// lag columns are multiples of 128 (precompute_fused_tables), so no tile
// straddles Cf and Sf or Ec and Es.
//
// Plain C interface, bound from Python with ctypes; built with
//   nvcc -gencode=arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared
// by narrow_band_least_squares_tpu_torch/ops/kernels/_build.py.

#include <climits>

#include "peak_tile.cuh"
#include "simt_ring.cuh"

namespace {

using namespace nbls;

constexpr int LAG_TILE = ring::BN;  // lags per inverse tile, both tiles
static_assert(LAG_TILE == TILE_N, "the tiles share the partials' layout");
constexpr int KSPLIT_F32 = 4;  // sample parts of the forward DFT, fp32 tile
constexpr int KSPLIT_TC = 3;   // and tensor-core tile

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Where spectra row r = (g*W + w)*C + c takes its window from.
struct WindowRow {
  const float* yr;  // the (g, c) trace
  const float* lm;  // the band's length mask
  int start;
  __device__ WindowRow(int r, const float* y, const int* hop,
                       const int* maxstart, const float* len_mask, int C,
                       int T, int Lg, int W) {
    const int c = r % C, gw = r / C;
    const int w = gw % W, g = gw / W;
    start = min(w * hop[g], maxstart[g]);
    yr = y + ((size_t)g * C + c) * T;
    lm = len_mask + (size_t)g * Lg;
  }
  // y * lm at sample t < Lg of the window (y zero past T)
  __device__ float masked(int t, int T) const {
    const int ti = start + t;
    return __fmul_rn((ti >= 0 && ti < T) ? yr[ti] : 0.f, lm[t]);
  }
};

// Stores x's tf32 hi (planes 1) or hi and lo (planes 2) at offset o of the
// planes hi / lo (the tensor-core routes' scratch).
__device__ __forceinline__ void put(float x, float* hi, float* lo, size_t o,
                                   int planes) {
  const float h = tf32_rna(x);
  hi[o] = h;
  if (planes == 2) lo[o] = tf32_rna(x - h);
}

// ---- pass 1: mean and energy of the chunk's (g, w, c) windows, rows row0 ..
// row0 + M of y's windows --------------------------------------------------
__global__ void window_stats_kernel(const float* __restrict__ y,
                                    const int* __restrict__ hop,
                                    const int* __restrict__ maxstart,
                                    const float* __restrict__ len_mask,
                                    float* __restrict__ mean,
                                    float* __restrict__ energy, int row0,
                                    int M, int C, int T, int Lg, int W) {
  const int row = (int)((blockIdx.x * (size_t)blockDim.x + threadIdx.x) >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= M) return;
  const WindowRow wr(row0 + row, y, hop, maxstart, len_mask, C, T, Lg, W);
  float s = 0.f, n = 0.f;
  for (int t = lane; t < Lg; t += 32) {
    s += wr.masked(t, T);
    n += wr.lm[t];
  }
  s = warp_sum(s);
  n = warp_sum(n);
  const float mu = s / n;
  float e = 0.f;
  for (int t = lane; t < Lg; t += 32) {
    const float x = __fmul_rn(__fsub_rn(wr.masked(t, T), mu), wr.lm[t]);
    e = fmaf(x, x, e);
  }
  e = warp_sum(e);
  if (lane == 0) {
    mean[row] = mu;
    energy[row] = e;
  }
}

// ---- pass 2: the windows, (y * lm - mean) * lm, into M x Lgp planes -------
__global__ void windows_kernel(const float* __restrict__ y,
                               const int* __restrict__ hop,
                               const int* __restrict__ maxstart,
                               const float* __restrict__ len_mask,
                               const float* __restrict__ mean,
                               float* __restrict__ w_hi,
                               float* __restrict__ w_lo, int row0, int C,
                               int T, int Lg, int W, int Lgp, int planes) {
  const int r = blockIdx.x;  // one block a row, its threads along the samples
  const WindowRow wr(row0 + r, y, hop, maxstart, len_mask, C, T, Lg, W);
  const float mu = mean[r];
  for (int t = threadIdx.x; t < Lgp; t += blockDim.x) {
    const float x =
        t < Lg ? __fmul_rn(__fsub_rn(wr.masked(t, T), mu), wr.lm[t]) : 0.f;
    put(x, w_hi, w_lo, (size_t)r * Lgp + t, planes);
  }
}

// ---- pass 2 (fp32): the same windows, K-major: win[t * ldm + r] for t <
// Lgp, as the ring tile reads A.  A block transposes 32 rows x 32 samples
// through shared memory, so that both the reads of y and the stores run
// along consecutive addresses --------------------------------------------
__global__ void windows_t_kernel(const float* __restrict__ y,
                                 const int* __restrict__ hop,
                                 const int* __restrict__ maxstart,
                                 const float* __restrict__ len_mask,
                                 const float* __restrict__ mean,
                                 float* __restrict__ win, int row0, int M,
                                 int C, int T, int Lg, int W, int Lgp,
                                 int ldm) {
  __shared__ float tile[32][33];
  const int t0 = blockIdx.x * 32, r0 = blockIdx.y * 32;
  const int tx = threadIdx.x, ty = threadIdx.y;  // 32 x 8
  for (int i = ty; i < 32; i += 8) {
    const int r = r0 + i, t = t0 + tx;
    float x = 0.f;
    if (r < M && t < Lg) {
      const WindowRow wr(row0 + r, y, hop, maxstart, len_mask, C, T, Lg, W);
      x = __fmul_rn(__fsub_rn(wr.masked(t, T), mean[r]), wr.lm[t]);
    }
    tile[i][tx] = x;
  }
  __syncthreads();
  for (int i = ty; i < 32; i += 8) {
    const int t = t0 + i, r = r0 + tx;
    if (t < Lgp && r < M) win[(size_t)t * ldm + r] = tile[tx][i];
  }
}

// Adds the parts of the spectra into part 0, in a fixed order.
__global__ void spectra_sum_kernel(float* __restrict__ spec, int n, int parts) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float v = spec[i];
  for (int z = 1; z < parts; ++z) v = __fadd_rn(v, spec[(size_t)z * n + i]);
  spec[i] = v;
}

// ---- pass 4: [Re CS | -Im CS] of every (g, w, p) row, CS = F_j conj(F_i),
// unfused as the plain version; one thread a frequency -----------------------
__global__ void cross_kernel(const float* __restrict__ spec,
                             const int* __restrict__ pairs,
                             float* __restrict__ c_hi, float* __restrict__ c_lo,
                             int R, int C, int P, int Kp, int planes) {
  const size_t n = (size_t)R * Kp;
  for (size_t e = blockIdx.x * (size_t)blockDim.x + threadIdx.x; e < n;
       e += (size_t)gridDim.x * blockDim.x) {
    const int r = (int)(e / Kp), k = (int)(e % Kp);
    const int p = r % P, gw = r / P;
    const float* si = spec + ((size_t)gw * C + pairs[2 * p]) * 2 * Kp;
    const float* sj = spec + ((size_t)gw * C + pairs[2 * p + 1]) * 2 * Kp;
    const float reI = si[k], imI = si[Kp + k], reJ = sj[k], imJ = sj[Kp + k];
    const float re = __fadd_rn(__fmul_rn(reJ, reI), __fmul_rn(imJ, imI));
    const float nim = -__fsub_rn(__fmul_rn(imJ, reI), __fmul_rn(reJ, imI));
    const size_t o = (size_t)r * 2 * Kp + k;
    put(re, c_hi, c_lo, o, planes);
    put(nim, c_hi, c_lo, o + Kp, planes);
  }
}

// ---- pass 4 (fp32): the same cross-spectra, K-major from K-major spectra:
// cs[k * ldr + r] = Re CS, cs[(Kp + k) * ldr + r] = -Im CS; threads along
// the rows, so a warp's pairs read a few neighbouring spectra rows --------
__global__ void cross_t_kernel(const float* __restrict__ spec,
                               const int* __restrict__ pairs,
                               float* __restrict__ cs, int R, int C, int P,
                               int Kp, int ldm, int ldr) {
  const size_t n = (size_t)R * Kp;
  for (size_t e = blockIdx.x * (size_t)blockDim.x + threadIdx.x; e < n;
       e += (size_t)gridDim.x * blockDim.x) {
    const int r = (int)(e % R), k = (int)(e / R);
    const int p = r % P, gw = r / P;
    const int ri = gw * C + pairs[2 * p], rj = gw * C + pairs[2 * p + 1];
    const float* re = spec + (size_t)k * ldm;
    const float* im = spec + (size_t)(Kp + k) * ldm;
    const float reI = re[ri], imI = im[ri], reJ = re[rj], imJ = im[rj];
    cs[(size_t)k * ldr + r] =
        __fadd_rn(__fmul_rn(reJ, reI), __fmul_rn(imJ, imI));
    cs[(size_t)(Kp + k) * ldr + r] =
        -__fsub_rn(__fmul_rn(imJ, reI), __fmul_rn(reJ, imI));
  }
}

// ---- pass 6: fold the lag tiles in order, rho = peak / sqrt(Ei Ej) --------
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

unsigned grid_for(size_t n) {
  const size_t blocks = (n + 255) / 256;
  return (unsigned)(blocks < 132 * 16 ? blocks : 132 * 16);
}

int round4(int x) { return (x + 3) / 4 * 4; }

// ---- pass 3 (fp32): the spectra [Re F | Im F] = win . [Cf | -Sf] on the
// ring tile, K-major into spec (2 Kp, ldm), the samples in parts of kpart,
// one cluster a tile ---------------------------------------------------------
int forward_ring(const float* win, int M, int ldm, int Lgp, int kpart,
                 const float* Cf, const float* Sf, int Lg, int Kp, float* spec,
                 cudaStream_t stream) {
  CUtensorMap maps[3];
  const int err = ring::encode_ring(maps, win, M, ldm, Lgp, Cf, Sf, Lg, Kp);
  if (err != 0) return err;
  const ring::RingOut o{nullptr, nullptr, 1, 0, nullptr, nullptr, spec, ldm, Kp};
  return ring::launch_ring<ring::RING_STORE>(
      maps, o, M, Lgp, kpart, 2 * Kp, INT_MAX, Kp, Lgp, stream);
}

// ---- pass 5 (fp32): the inverse DFT of the K-major cross-spectra (2 Kp,
// ldr) against [Ec ; Es], K in parts of kpart, one cluster a tile, reduced
// on chip to the tile's masked first-max partials; the chunk's row 0 is
// row row_base of rho.  Rows of Ec and Es at or past kinv are zero and
// skipped ----------------------------------------------------------------
int inverse_ring(const float* cs, int R, int ldr, int Kp, int kpart, int kinv,
                 const float* Ec, const float* Es, int nlag, const int* lo,
                 const int* hi, int bdiv, int row_base, float* part_val,
                 int* part_idx, cudaStream_t stream) {
  CUtensorMap maps[3];
  const int err = ring::encode_ring(maps, cs, R, ldr, 2 * Kp, Ec, Es, Kp, nlag);
  if (err != 0) return err;
  const ring::RingOut o{lo, hi, bdiv, row_base, part_val, part_idx, nullptr, 0, 0};
  const int kvalid = (kinv + ring::BK - 1) / ring::BK * ring::BK;
  return ring::launch_ring<ring::RING_PEAK>(
      maps, o, R, 2 * Kp, kpart, nlag, Kp, INT_MAX, kvalid, stream);
}

}  // namespace

extern "C" {

// Lags per xcorr block: the partial buffers hold nlag / lag_tile * R.
int nbls_fused_xcorr_lag_tile(void) { return LAG_TILE; }

// Samples per tensor-core K block: the windows' scratch and the split
// forward table have Lg rounded up to a multiple of this.
int nbls_fused_xcorr_k_block(void) { return TILE_K; }

// Parts of the forward DFT's sum over the samples at nprod (0: fp32 tile;
// 1, 3: tensor cores): the spectra scratch holds parts * gw_chunk*C * 2 Kp.
int nbls_fused_xcorr_ksplit(int nprod) {
  return nprod == 0 ? KSPLIT_F32 : KSPLIT_TC;
}

// Samples or frequencies per K chunk at nprod: every K part is whole chunks.
int nbls_fused_xcorr_k_chunk(int nprod) { return nprod == 0 ? ring::BK : TILE_K; }

// The fp32 ring tile's dynamic shared memory a CTA, and how many clusters
// of `parts` CTAs of its forward (store != 0) or inverse kernel the card
// holds at once (negative: -cudaError_t).
int nbls_fused_xcorr_ring_smem(void) { return ring::SMEM; }
int nbls_fused_xcorr_max_clusters(int store, int parts) {
  return store ? ring::max_active_clusters<ring::RING_STORE>(parts)
               : ring::max_active_clusters<ring::RING_PEAK>(parts);
}

// Launches the passes on `stream`, chunk by chunk; returns 0, or 10000 *
// pass + the error of the pass that failed (pass 1 window statistics, 2
// windows, 3 forward DFT, 4 cross-spectra, 5 inverse DFT, 6 merge; error: a
// cudaError_t, 1001 for no tensor-map encoder in the driver, 1002 for a
// refused tensor map).
//   nprod: 0 for IEEE fp32, 3 for 3xTF32, 1 for one tf32 pass;
//   Cf/Sf (Lg, Kp), Ec/Es (Kp, nlag), Kp and nlag multiples of 128;
//   fwd_t (planes, 2 Kp, Lgp) = split [Cf | Sf]^T and inv_t (planes, nlag,
//   2 Kp) = split [Ec ; Es]^T (nprod > 0 only; the lo plane, after hi, is
//   read at nprod 3);
//   gw_chunk: windows (g, w) per chunk, at least 1;
//   kpart_inv (nprod 0): the inverse DFT's K part, a multiple of
//   k_chunk(0) with 2 Kp / kpart_inv <= 8 parts (a cluster);
//   kinv (nprod 0): the rows of Ec and Es that may be nonzero (Lg + 1 in
//   the tables of precompute_fused_tables), 1 .. Kp: the rows past it are
//   skipped;
// scratch, allocated by the caller for one chunk (n = gw_chunk; r4(x): x
// rounded up to a multiple of 4):
//   mean, energy: n*C floats each;
//   win: (nprod == 3 ? 2 : 1) * n*C * Lgp floats (Lgp: Lg rounded up to
//   the K block); K-major Lgp x r4(n*C) at nprod 0;
//   spec: ksplit(nprod) * n*C * 2 Kp floats; K-major 2 Kp x r4(n*C) at
//   nprod 0 (the parts meet on chip);
//   cs: (nprod == 3 ? 2 : 1) * n*P * 2 Kp floats; K-major 2 Kp x r4(n*P)
//   at nprod 0;
//   part_val, part_idx: nlag / lag_tile * n*P each.
int nbls_fused_xcorr(const float* y, const int* hop, const int* maxstart,
                     const int* lo, const int* hi, const float* len_mask,
                     const float* Cf, const float* Sf, const float* Ec,
                     const float* Es, const int* pairs, const float* fwd_t,
                     const float* inv_t, float* rho, int* idx, float* mean,
                     float* energy, float* win, float* spec, float* cs,
                     float* part_val, int* part_idx, int Bg, int C, int T,
                     int Lg, int W, int Kp, int nlag, int P, int nprod,
                     int gw_chunk, int kpart_inv, int kinv,
                     cudaStream_t stream) {
  if (Bg <= 0 || C <= 0 || T <= 0 || Lg <= 0 || W <= 0 || Kp <= 0 ||
      nlag <= 0 || P <= 0 || gw_chunk <= 0 || Kp % LAG_TILE != 0 ||
      nlag % LAG_TILE != 0 || (nprod != 0 && nprod != 1 && nprod != 3) ||
      (nprod == 0 && (kpart_inv <= 0 || kpart_inv % ring::BK != 0 ||
                      (2 * Kp + kpart_inv - 1) / kpart_inv > ring::MAX_PARTS ||
                      kinv <= 0 || kinv > Kp)))
    return (int)cudaErrorInvalidValue;
  const int ngw = Bg * W;
  const int ntiles = nlag / LAG_TILE;
  const int Lgp = (Lg + TILE_K - 1) / TILE_K * TILE_K;
  const bool tc = nprod != 0;
  const int planes = nprod == 3 ? 2 : 1;  // the tensor cores', as put() takes them
  const int ksplit = nbls_fused_xcorr_ksplit(nprod);
  // samples per part: whole K chunks (fp32) or K blocks (tensor cores)
  const int kq = nbls_fused_xcorr_k_chunk(nprod);
  const int kpart = (Lgp / kq + ksplit - 1) / ksplit * kq;
  const auto failed = [](int pass, int e) {
    return 10000 * pass + (e < 0 ? 1000 - e : e);
  };
  int err;

  for (int gw0 = 0; gw0 < ngw; gw0 += gw_chunk) {
    const int n = min(gw_chunk, ngw - gw0);
    const int M = n * C;  // spectra rows of the chunk
    const int R = n * P;  // correlation rows of the chunk

    window_stats_kernel<<<(M + 7) / 8, 256, 0, stream>>>(
        y, hop, maxstart, len_mask, mean, energy, gw0 * C, M, C, T, Lg, W);
    if ((err = (int)cudaGetLastError()) != 0) return failed(1, err);

    const int ldm = round4(M), ldr = round4(R);  // K-major rows (fp32)
    float* w_lo = nprod == 3 ? win + (size_t)M * Lgp : win;
    if (!tc)
      windows_t_kernel<<<dim3(Lgp / 32, (M + 31) / 32), dim3(32, 8), 0,
                         stream>>>(y, hop, maxstart, len_mask, mean, win,
                                   gw0 * C, M, C, T, Lg, W, Lgp, ldm);
    else
      windows_kernel<<<M, 256, 0, stream>>>(y, hop, maxstart, len_mask, mean,
                                            win, w_lo, gw0 * C, C, T, Lg, W,
                                            Lgp, planes);
    if ((err = (int)cudaGetLastError()) != 0) return failed(2, err);

    CUtensorMap maps[4];
    if (!tc) {
      err = forward_ring(win, M, ldm, Lgp, kpart, Cf, Sf, Lg, Kp, spec, stream);
    } else {
      const float* f_lo = nprod == 3 ? fwd_t + (size_t)2 * Kp * Lgp : fwd_t;
      err = encode_operands(maps, win, w_lo, M, fwd_t, f_lo, 2 * Kp, Lgp);
      const TcOut fo{nullptr, nullptr, 1, 0, nullptr, nullptr, spec, 2 * Kp, Kp};
      if (err == 0)
        err = nprod == 3 ? launch_tc_tiles<3, EPI_STORE>(maps, fo, M, Lgp,
                                                         kpart, 2 * Kp, stream)
                         : launch_tc_tiles<1, EPI_STORE>(maps, fo, M, Lgp,
                                                         kpart, 2 * Kp, stream);
    }
    if (err == 0 && tc) {
      const int ns = M * 2 * Kp;
      spectra_sum_kernel<<<(ns + 255) / 256, 256, 0, stream>>>(
          spec, ns, (Lgp + kpart - 1) / kpart);
      err = (int)cudaGetLastError();
    }
    if (err != 0) return failed(3, err);

    float* c_lo = nprod == 3 ? cs + (size_t)R * 2 * Kp : cs;
    if (!tc)
      cross_t_kernel<<<grid_for((size_t)R * Kp), 256, 0, stream>>>(
          spec, pairs, cs, R, C, P, Kp, ldm, ldr);
    else
      cross_kernel<<<grid_for((size_t)R * Kp), 256, 0, stream>>>(
          spec, pairs, cs, c_lo, R, C, P, Kp, planes);
    if ((err = (int)cudaGetLastError()) != 0) return failed(4, err);

    if (!tc) {
      err = inverse_ring(cs, R, ldr, Kp, kpart_inv, kinv, Ec, Es, nlag, lo, hi,
                         W * P, gw0 * P, part_val, part_idx, stream);
    } else {
      const float* i_lo = nprod == 3 ? inv_t + (size_t)nlag * 2 * Kp : inv_t;
      err = encode_operands(maps, cs, c_lo, R, inv_t, i_lo, nlag, 2 * Kp);
      const TcOut xo{lo, hi, W * P, gw0 * P, part_val, part_idx, nullptr, 0, 0};
      if (err == 0)
        err = nprod == 3 ? launch_tc_tiles<3, EPI_PEAK>(maps, xo, R, 2 * Kp,
                                                        2 * Kp, nlag, stream)
                         : launch_tc_tiles<1, EPI_PEAK>(maps, xo, R, 2 * Kp,
                                                        2 * Kp, nlag, stream);
    }
    if (err != 0) return failed(5, err);

    merge_kernel<<<(R + 255) / 256, 256, 0, stream>>>(
        part_val, part_idx, energy, pairs, rho + (size_t)gw0 * P,
        idx + (size_t)gw0 * P, R, C, P, ntiles);
    if ((err = (int)cudaGetLastError()) != 0) return failed(6, err);
  }
  return 0;
}

}  // extern "C"
