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
// Design:
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
//
// Plain C interface, bound from Python with ctypes; built with
//   nvcc -gencode=arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared
// by narrow_band_least_squares_tpu_torch/ops/kernels/_build.py.  The
// tensor-map encoder is fetched from the driver at run time
// (cudaGetDriverEntryPoint), so nothing links against libcuda.

#include "peak_tile.cuh"

namespace {

using namespace nbls;

constexpr int CONSUMERS = 3;                    // consumer warpgroups
constexpr int BM = CONSUMERS * TILE_M;          // 192 rows per CTA
constexpr int THREADS = (CONSUMERS + 1) * WG_THREADS;  // + the producer's
// Registers a thread after setmaxnreg: the producer warpgroup gives up most
// of its own to the consumers, which hold two 64-float fragments each
// (24 x 128 + 160 x 384 <= 65,536).
constexpr int PRODUCER_REGS = 24;
constexpr int CONSUMER_REGS = 160;
constexpr int A_TILE = BM * TILE_K * 4;         // 24 KB
constexpr int B_TILE = TILE_N * TILE_K * 4;     // 16 KB

template <int NPROD>
struct Cfg {
  static constexpr int PLANES = NPROD == 3 ? 2 : 1;  // hi (and lo)
  static constexpr int STAGE = PLANES * (A_TILE + B_TILE);
  static constexpr int STAGES = NPROD == 3 ? 2 : 4;  // 160 KB either way
  // K blocks whose products the tensor cores sum before the fp32 fold: 12
  // truncating additions between folds at 'high' (3 x 4 k-steps), 16 at
  // 'default', where a fold per block would drain the pipe every 4 products
  static constexpr int FOLD = NPROD == 3 ? 1 : 4;
  static constexpr int SMEM = STAGES * STAGE + 2 * STAGES * 8 + 1024;
};

template <int NPROD>
__global__ void __launch_bounds__(THREADS, 1)
    icorr_peak_tc_kernel(const __grid_constant__ CUtensorMap a_hi_map,
                         const __grid_constant__ CUtensorMap a_lo_map,
                         const __grid_constant__ CUtensorMap b_hi_map,
                         const __grid_constant__ CUtensorMap b_lo_map,
                         const int* __restrict__ lo,
                         const int* __restrict__ hi,
                         float* __restrict__ part_val,
                         int* __restrict__ part_idx, int R, int K2p,
                         int nlag) {
  using C = Cfg<NPROD>;
  const int row0 = blockIdx.x * BM;
  const int lag0 = blockIdx.y * TILE_N;
  const int t = threadIdx.x;
  const size_t part0 = (size_t)blockIdx.y * R;

  bool needed = false;
  if (t < BM && row0 + t < R) {
    const int l = lo[row0 + t], h = hi[row0 + t];
    needed = l <= h && l <= lag0 + TILE_N - 1 && h >= lag0;
  }
  if (!__syncthreads_or(needed)) {
    if (t < BM && row0 + t < R) {
      part_val[part0 + row0 + t] = -CUDART_INF_F;
      part_idx[part0 + row0 + t] = 0;
    }
    return;
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

  const int nk = K2p / TILE_K;
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
        const int k0 = kb * TILE_K;
        mbar_expect_tx(&full[s], C::STAGE);
        tma_load_2d(st, &a_hi_map, &full[s], k0, row0);
        tma_load_2d(sb, &b_hi_map, &full[s], k0, lag0);
        if (NPROD == 3) {
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
                       st + (NPROD == 3 ? A_TILE : 0) + a_off, sb,
                       sb + (NPROD == 3 ? B_TILE : 0), kb % C::FOLD != 0);
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
  int lo_a = 1, hi_a = 0, lo_b = 1, hi_b = 0;  // empty ranges past R
  if (ra < R) {
    lo_a = lo[ra];
    hi_a = hi[ra];
  }
  if (rb < R) {
    lo_b = lo[rb];
    hi_b = hi[rb];
  }
  const TileBest b = tile_first_max(acc, lag0, nlag, lo_a, hi_a, lo_b, hi_b);
  if ((lane & 3) == 0) {
    if (ra < R) {
      part_val[part0 + ra] = b.va;
      part_idx[part0 + ra] = b.ia;
    }
    if (rb < R) {
      part_val[part0 + rb] = b.vb;
      part_idx[part0 + rb] = b.ib;
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
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

// A row-major (rows, K2p) fp32 matrix, read in boxes of 32 x box_rows.
bool encode(EncodeTiled fn, CUtensorMap* map, const float* base, int rows,
            int K2p, int box_rows) {
  const cuuint64_t dims[2] = {(cuuint64_t)K2p, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)K2p * sizeof(float)};
  const cuuint32_t box[2] = {(cuuint32_t)TILE_K, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2,
            const_cast<float*>(base), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int NPROD>
int launch_tiles(const CUtensorMap* maps, const int* lo, const int* hi,
                 float* part_val, int* part_idx, int R, int K2p, int nlag,
                 cudaStream_t stream) {
  using C = Cfg<NPROD>;
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        icorr_peak_tc_kernel<NPROD>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const dim3 grid((R + BM - 1) / BM, (nlag + TILE_N - 1) / TILE_N);
  icorr_peak_tc_kernel<NPROD><<<grid, THREADS, C::SMEM, stream>>>(
      maps[0], maps[1], maps[2], maps[3], lo, hi, part_val, part_idx, R, K2p,
      nlag);
  return (int)cudaGetLastError();
}

// The tf32 split of n fp32 values (n a multiple of 4): hi, and lo unless
// it is null.  Returns the cudaError_t of the launch.
int launch_split(const float* x, float* hi, float* lo, long long n,
                 cudaStream_t stream) {
  const long long n4 = n / 4;
  const long long blocks = (n4 + 255) / 256 < 132 * 16 ? (n4 + 255) / 256
                                                         : 132 * 16;
  tf32_split_kernel<<<(unsigned)blocks, 256, 0, stream>>>(
      reinterpret_cast<const float4*>(x), reinterpret_cast<float4*>(hi),
      reinterpret_cast<float4*>(lo), n4);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Lags per tile: e2's split table has nlag_p rows, a multiple of this, and
// the partials hold ceil(nlag / lag_tile) x R values.
int nbls_icorr_peak_tc_lag_tile(void) { return TILE_N; }

// Dynamic shared memory of the tile kernel for nprod (1 or 3) products.
int nbls_icorr_peak_tc_smem_bytes(int nprod) {
  return nprod == 3 ? Cfg<3>::SMEM : Cfg<1>::SMEM;
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
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return -1;
  const size_t a_plane = (size_t)R * K2p, b_plane = (size_t)nlag_p * K2p;
  float* a_hi = a_split;
  float* a_lo = nprod == 3 ? a_split + a_plane : nullptr;
  int err = launch_split(cs2, a_hi, a_lo, (long long)a_plane, stream);
  if (err != 0) return err;
  CUtensorMap maps[4];
  if (!encode(fn, &maps[0], a_hi, R, K2p, BM) ||
      !encode(fn, &maps[1], nprod == 3 ? a_lo : a_hi, R, K2p, BM) ||
      !encode(fn, &maps[2], e2t, nlag_p, K2p, TILE_N) ||
      !encode(fn, &maps[3], e2t + b_plane, nlag_p, K2p, TILE_N))
    return -2;
  err = nprod == 3 ? launch_tiles<3>(maps, lo, hi, part_val, part_idx, R, K2p,
                                     nlag, stream)
                   : launch_tiles<1>(maps, lo, hi, part_val, part_idx, R, K2p,
                                     nlag, stream);
  if (err != 0) return err;
  const int ntiles = (nlag + TILE_N - 1) / TILE_N;
  peak_merge_kernel<<<(R + 255) / 256, 256, 0, stream>>>(part_val, part_idx,
                                                         peak, idx, R, ntiles);
  return (int)cudaGetLastError();
}

}  // extern "C"
