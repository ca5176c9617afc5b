// icorr_peak on Hopper's tensor cores (sm_90a): the inverse-DFT correlation
// in tf32 wgmma and its masked first-max, for matmul_precision 'high'
// (3xTF32) and 'default' (1xTF32).  'highest' stays on the IEEE-fp32 CUDA-core
// kernel of xcorr_peak.cu.
//
// Replaces the TPU kernel narrow_band_least_squares_tpu/ops/kernels/
// xcorr_peak.py::icorr_peak (body _peak_kernel, pallas_call at :128), whose
// in-kernel dot runs at the caller's precision: bf16x3 for 'high', one bf16
// pass for 'default'.  For every row r of cs2 (R, K2p) and lag l < nlag:
//     cc[r, l] = sum_k cs2[r, k] * e2[k, l]     (split products, fp32 sums)
//     peak[r]  = max over lo[r] <= l <= hi[r] of cc[r, l]
//     idx[r]   = the FIRST l that reaches it (jnp.argmax tie-break)
// A row with no valid lag gives peak = -inf, idx = 0.
//
// What bounds it: tensor-core operations.  At 'high' every fp32
// multiply-add is three tf32 products (lo.hi + hi.lo + hi.hi), so the
// canonical step's 77 GFLOP is 232 tf32 GFLOP: 0.47 ms at 495 TFLOP/s,
// against 1.15 ms for fp32 on the CUDA cores.  The inputs are a few tens of
// MB and stay in L2; the (R, nlag) correlation never reaches memory.  What
// holds the kernel back from that bound is how fast a block's operands
// reach shared memory: at 'high' a 32-wide K block is 80 KB (hi and lo of
// A and B) for 4.7 tf32 MFLOP.
//
// Design (the tile is tc_tile_kernel of peak_tile.cuh, shared with
// fused_xcorr_bucket):
// - cs2 is split per call into hi/lo planes by a small elementwise pass
//   (tf32_split_kernel); e2 arrives already transposed and split, (2,
//   nlag_p, K2p), built once with the pipeline, because wgmma takes tf32 B
//   only K-major.
// - One CTA per (192-row, 128-lag) tile: one producer thread keeps TMA loads
//   of the hi/lo tiles of A and B (32-wide K blocks, 128B swizzle) in flight
//   through a ring of shared-memory stages (2 at 'high', 4 at 'default');
//   three consumer warpgroups of 64 rows each run m64n128k8 wgmma on the
//   stage that arrived and release it to the producer.  192 rows, not 128,
//   put each canonical bucket (171-180 tiles of 128 rows, two waves) in one
//   wave of 112-126 CTAs on the 132 SMs, and load each B tile for three
//   warpgroups instead of two.  The producer warpgroup hands most of its
//   registers to the consumers (setmaxnreg).
// - The tensor cores' own fp32 accumulation does not round to nearest, so
//   the products of each 32-wide K block ('high'; 4 blocks at 'default') go
//   to a fresh fragment that the warpgroup adds into its running sum in
//   registers; the other warpgroups' products keep the tensor cores busy
//   meanwhile.
// - The epilogue reduces the accumulator fragment to a (max, first lag)
//   per row and writes it as the tile's partial; a second pass folds the
//   lag tiles in ascending order with a strict >, as the CUDA-core kernel
//   does.  No split-K: every (row, lag) value is the same K-ordered sum
//   whatever R or the grid, so exact ties stay exact and merged
//   multi-array runs equal single-array runs.
// - A tile whose rows all search outside its 128 lags is skipped.
// - Ragged R rows arrive from TMA as zeros; lags past nlag are masked.
// - With sub-sample delays (nbls_icorr_peak_tc_nb, the EPI_PEAK_NB
//   epilogue) each row's two neighbouring correlations come from the
//   accumulator fragment that holds the peak, one quad shuffle away, so
//   they carry the peak's own rounding at 'high' and 'default'; each tile
//   also writes its first and last column, from which the fold patches a
//   neighbour in the adjacent tile.
//
// Plain C interface, bound from Python with ctypes; built with
//   nvcc -gencode=arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared
// by narrow_band_least_squares_tpu_torch/ops/kernels/_build.py.  The
// tensor-map encoder is fetched from the driver at run time
// (cudaGetDriverEntryPoint), so nothing links against libcuda.

#include "peak_tile.cuh"

using namespace nbls;

extern "C" {

// Lags per tile: e2's split table has nlag_p rows, a multiple of this, and
// the partials hold ceil(nlag / lag_tile) x R values.
int nbls_icorr_peak_tc_lag_tile(void) { return TILE_N; }

// Dynamic shared memory of the tile kernel for nprod (1 or 3) products.
int nbls_icorr_peak_tc_smem_bytes(int nprod) {
  return nprod == 3 ? TcCfg<3>::SMEM : TcCfg<1>::SMEM;
}

// Launches the split of cs2, the tile kernel and the fold on `stream`.
//   cs2 (R, K2p), K2p a multiple of 32; a_split: scratch of nprod == 3 ? 2 : 1 planes of R x K2p;
//   e2t (2, nlag_p, K2p): rna(e2^T) and rna(e2^T - hi), zero rows past nlag;
//   part_val / part_idx: scratch of ceil(nlag / lag_tile) x R each.
// Returns 0, a cudaError_t, or -1 (no tensor-map encoder in the driver),
// -2 (a tensor map was refused).
int nbls_icorr_peak_tc(const float* cs2, float* a_split, const float* e2t,
                       const int* lo, const int* hi, float* peak, int* idx,
                       float* part_val, int* part_idx, int R, int K2p,
                       int nlag, int nlag_p, int nprod, cudaStream_t stream) {
  if (R <= 0 || nlag <= 0 || K2p <= 0 || K2p % TILE_K != 0 ||
      nlag_p % TILE_N != 0 || nlag_p < nlag || (nprod != 1 && nprod != 3))
    return (int)cudaErrorInvalidValue;
  const size_t a_plane = (size_t)R * K2p, b_plane = (size_t)nlag_p * K2p;
  float* a_hi = a_split;
  float* a_lo = nprod == 3 ? a_split + a_plane : a_split;
  int err = launch_split(cs2, a_hi, nprod == 3 ? a_lo : nullptr,
                         (long long)a_plane, stream);
  if (err != 0) return err;
  CUtensorMap maps[4];
  err = encode_operands(maps, a_hi, a_lo, R, e2t,
                        nprod == 3 ? e2t + b_plane : e2t, nlag_p, K2p);
  if (err != 0) return err;
  const TcOut o{lo, hi, 1, 0, part_val, part_idx, nullptr, 0, 0};
  err = nprod == 3
            ? launch_tc_tiles<3, EPI_PEAK>(maps, o, R, K2p, K2p, nlag, stream)
            : launch_tc_tiles<1, EPI_PEAK>(maps, o, R, K2p, K2p, nlag, stream);
  if (err != 0) return err;
  const int ntiles = (nlag + TILE_N - 1) / TILE_N;
  peak_merge_kernel<<<(R + 255) / 256, 256, 0, stream>>>(part_val, part_idx,
                                                         peak, idx, R, ntiles);
  return (int)cudaGetLastError();
}

// nbls_icorr_peak_tc, and per row the correlations at idx - 1 and idx + 1
// from the same accumulators (the EPI_PEAK_NB epilogue) into cm / cp (0
// where idx is 0, nlag - 1 or the row has no valid lag).  part_nb: scratch
// of 4 x ceil(nlag / lag_tile) x R.
int nbls_icorr_peak_tc_nb(const float* cs2, float* a_split, const float* e2t,
                          const int* lo, const int* hi, float* peak, int* idx,
                          float* cm, float* cp, float* part_val, int* part_idx,
                          float* part_nb, int R, int K2p, int nlag, int nlag_p,
                          int nprod, cudaStream_t stream) {
  if (R <= 0 || nlag <= 0 || K2p <= 0 || K2p % TILE_K != 0 ||
      nlag_p % TILE_N != 0 || nlag_p < nlag || (nprod != 1 && nprod != 3))
    return (int)cudaErrorInvalidValue;
  const size_t a_plane = (size_t)R * K2p, b_plane = (size_t)nlag_p * K2p;
  float* a_hi = a_split;
  float* a_lo = nprod == 3 ? a_split + a_plane : a_split;
  int err = launch_split(cs2, a_hi, nprod == 3 ? a_lo : nullptr,
                         (long long)a_plane, stream);
  if (err != 0) return err;
  CUtensorMap maps[4];
  err = encode_operands(maps, a_hi, a_lo, R, e2t,
                        nprod == 3 ? e2t + b_plane : e2t, nlag_p, K2p);
  if (err != 0) return err;
  const TcOut o{lo, hi, 1, 0, part_val, part_idx, nullptr, 0, 0, part_nb};
  err = nprod == 3
            ? launch_tc_tiles<3, EPI_PEAK_NB>(maps, o, R, K2p, K2p, nlag, stream)
            : launch_tc_tiles<1, EPI_PEAK_NB>(maps, o, R, K2p, K2p, nlag, stream);
  if (err != 0) return err;
  const int ntiles = (nlag + TILE_N - 1) / TILE_N;
  peak_merge_nb_kernel<<<(R + 255) / 256, 256, 0, stream>>>(
      part_val, part_idx, part_nb, peak, idx, cm, cp, R, ntiles, TILE_N);
  return (int)cudaGetLastError();
}

}  // extern "C"
