// The fp32 CUDA-core ring tile for Hopper (sm_90a): a BM-row x 128-column
// tile of C = A . B accumulated in registers with one fmaf per term, K
// ascending, over one fixed K part per CTA; the K parts of a tile are the
// CTAs of one thread-block cluster, added on chip in part order, then
// reduced to a masked first maximum per row or stored K-major.  Used by
// both products of fused_xcorr_bucket at matmul_precision 'highest'
// (fused_xcorr.cu).
//
// What bounds it: the fp32 FMA rate (128 per SM per clock).  The design
// keeps the FMA pipes fed without a block-wide barrier in the mainloop:
//   - both operands arrive by TMA (cp.async.bulk.tensor) into a ring of
//     STAGES shared-memory stages of BK = 16 k each, A already K-major in
//     device memory (the caller's scratch), so no thread stages or
//     transposes an operand; each stage has a `full` mbarrier (the TMA
//     bytes) and an `empty` one (one arrival per warp when it is done);
//   - thread 0 issues the loads, STAGES - 1 chunks ahead: after its own
//     math on chunk c it refills the stage of chunk c - 1, so it waits only
//     for the slowest warp to finish the chunk before the one it just did;
//   - a 64 x 128 tile, 128 threads, each owning 8 x 8 accumulators (two
//     groups of 4 rows 32 apart by two groups of 4 columns 64 apart, 16
//     lanes across the columns): one k step reads 4 float4 from shared
//     memory for 64 FMAs, A's reads broadcast; <= 128 registers, 4 CTAs an
//     SM.  On an H100, 16 x 8 accumulators a thread (255 registers, 2 CTAs
//     an SM) and 256-thread CTAs ran slower, and warps as 32 x 64 blocks no
//     faster (PERF.md).
// K parts: CTA z of a cluster of `parts` CTAs (blockIdx.z) sums K range
// [z * kpart, min(K, (z + 1) * kpart)) as one fmaf chain from 0.  After the
// mainloop every CTA writes its accumulators to its own shared memory (over
// the stages), the cluster synchronises, and CTA z takes rows [z * per,
// (z + 1) * per) of the tile (per = ceil(BM / parts)): each value is
// ((p0 + p1) + p2) + ... over the parts' shared memory (distributed shared
// memory, map_shared_rank), fp32 adds in part order, then the epilogue.  A
// second cluster barrier keeps every CTA alive until the others have read
// it.  So an output is a function of its own row, the B operand and the
// part plan (K, kpart) alone: never of how many rows share the launch.
//
// Plain CUDA: no PyTorch header.

#pragma once

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "peak_tile.cuh"  // mbarriers, TMA loads, the tensor-map encoder

namespace nbls {
namespace ring {

namespace cg = cooperative_groups;

constexpr int BM = 64;             // rows per CTA
constexpr int BN = 128;            // columns per CTA
constexpr int BK = 16;             // k per stage
constexpr int TM = 8;              // rows per thread
constexpr int TN = 8;              // columns per thread
constexpr int NT = 128;            // threads per CTA
constexpr int WARPS = NT / 32;
constexpr int MIN_CTAS = 4;        // CTAs an SM: <= 128 registers a thread
constexpr int STAGES = 4;
constexpr int MAX_PARTS = 8;       // the portable cluster size

constexpr int A_BYTES = BK * BM * 4;   // a stage: A, then B
constexpr int B_BYTES = BK * BN * 4;
constexpr int STAGE = A_BYTES + B_BYTES;
constexpr int LDD = BN + 4;            // a row of the accumulator dump
constexpr int DUMP = BM * LDD * 4;
constexpr int BODY = STAGES * STAGE > DUMP ? STAGES * STAGE : DUMP;
constexpr int SMEM = BODY + 2 * STAGES * 8 + 128;  // + barriers, alignment
static_assert(NT >= BM, "one thread per row checks the tile's lag ranges");
static_assert(NT == 32 * WARPS && TM == 8 && TN == 8, "64 accumulators a thread");

enum : int { RING_PEAK = 0, RING_STORE = 1 };

struct RingOut {
  // RING_PEAK: row r searches [lo, hi][(row_base + r) / bdiv] below ncols;
  // its partial lands at part_val / part_idx[blockIdx.y * R + r]
  const int* lo;
  const int* hi;
  int bdiv;
  int row_base;
  float* part_val;
  int* part_idx;
  // RING_STORE: out[col * ldo + r] (K-major), negated in columns >= neg_from
  float* out;
  int ldo;
  int neg_from;
};

// Operands: A (K, rows) K-major through a_map, boxes of BK x BM; B from two
// row-major (krows, ncols) tables b0 / b1 in boxes of BK x BN: chunk k of
// column col0 reads b1 at row k - ksplit where k >= ksplit, or at column
// col0 - nsplit where col0 >= nsplit, else b0.  Rows past a tensor's end
// arrive as 0.  Table rows at or past kvalid (a multiple of BK) are zero
// and are skipped: their terms would add nothing.
template <int EPI>
__global__ void __launch_bounds__(NT, MIN_CTAS)
    ring_tile_kernel(const __grid_constant__ CUtensorMap a_map,
                     const __grid_constant__ CUtensorMap b0_map,
                     const __grid_constant__ CUtensorMap b1_map,
                     const RingOut o, int R, int K, int kpart, int ncols,
                     int ksplit, int nsplit, int kvalid) {
  cg::cluster_group cluster = cg::this_cluster();
  const int part = blockIdx.z, parts = gridDim.z;  // a cluster is (1, 1, parts)
  const int row0 = blockIdx.x * BM, col0 = blockIdx.y * BN;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const size_t part0 = (size_t)blockIdx.y * R;

  if (EPI == RING_PEAK) {  // the same answer in every CTA of the cluster
    bool needed = false;
    if (t < BM && row0 + t < R) {
      const int b = (o.row_base + row0 + t) / o.bdiv;
      const int l = o.lo[b], h = o.hi[b];
      needed = l <= h && l <= col0 + BN - 1 && h >= col0;
    }
    if (!__syncthreads_or(needed)) {
      if (part == 0 && t < BM && row0 + t < R) {
        o.part_val[part0 + row0 + t] = -CUDART_INF_F;
        o.part_idx[part0 + row0 + t] = 0;
      }
      return;
    }
  }

  extern __shared__ __align__(128) uint8_t ring_smem[];
  uint8_t* smem = ring_smem + ((128 - (smem_u32(ring_smem) & 127)) & 127);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + BODY);
  uint64_t* empty = full + STAGES;
  if (t == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], WARPS);
    }
    mbar_init_fence();
  }
  __syncthreads();

  // this part's chunks: K range [kb, ke) without the table rows at or past
  // kvalid, so [kb, e0) of b0 and [a1, e1) past ksplit, in order
  const int kb = part * kpart, ke = min(K, kb + kpart);
  const int e0 = min(ke, min(ksplit, kvalid));
  const int a1 = max(kb, ksplit);
  const int e1 = ksplit < K ? min(ke, ksplit + kvalid) : 0;
  const int n0 = max(0, e0 - kb) / BK;
  const int nk = n0 + max(0, e1 - a1) / BK;
  const bool right = col0 >= nsplit;
  const int bcol = right ? col0 - nsplit : col0;
  const CUtensorMap* am = &a_map;
  const CUtensorMap* b0m = &b0_map;
  const CUtensorMap* b1m = &b1_map;
  const auto issue = [=](int c) {  // chunk c into stage c % STAGES
    const int s = c % STAGES, k = c < n0 ? kb + c * BK : a1 + (c - n0) * BK;
    uint8_t* st = smem + s * STAGE;
    mbar_expect_tx(&full[s], STAGE);
    tma_load_2d(st, am, &full[s], row0, k);
    tma_load_2d(st + A_BYTES, (right || k >= ksplit) ? b1m : b0m, &full[s],
                bcol, k >= ksplit ? k - ksplit : k);
  };

  // the thread's first row and column; its row groups are 32 rows apart,
  // its column groups 64 columns
  const int arow = (t / 16) * 4, bcol_t = (t % 16) * 4;
  constexpr int RSTEP = 32, CSTEP = BN / 2;
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  if (t == 0)
    for (int c = 0; c < STAGES - 1 && c < nk; ++c) issue(c);
  for (int c = 0; c < nk; ++c) {
    const int s = c % STAGES;
    mbar_wait(&full[s], (c / STAGES) & 1);
    const float* sa = reinterpret_cast<const float*>(smem + s * STAGE);
    const float* sb = reinterpret_cast<const float*>(smem + s * STAGE + A_BYTES);
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      float a[TM], b[TN];
#pragma unroll
      for (int g = 0; g < TM / 4; ++g) {
        const float4 v =
            *reinterpret_cast<const float4*>(sa + k * BM + g * RSTEP + arow);
        a[4 * g] = v.x;
        a[4 * g + 1] = v.y;
        a[4 * g + 2] = v.z;
        a[4 * g + 3] = v.w;
      }
      const float4 b0 = *reinterpret_cast<const float4*>(sb + k * BN + bcol_t);
      const float4 b1 =
          *reinterpret_cast<const float4*>(sb + k * BN + CSTEP + bcol_t);
      b[0] = b0.x; b[1] = b0.y; b[2] = b0.z; b[3] = b0.w;
      b[4] = b1.x; b[5] = b1.y; b[6] = b1.z; b[7] = b1.w;
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
    const int n = c + STAGES - 1;  // refills the stage chunk c - 1 used
    if (t == 0 && n < nk) {
      if (n >= STAGES) mbar_wait(&empty[n % STAGES], ((n - STAGES) / STAGES) & 1);
      issue(n);
    }
  }

  // the parts meet in shared memory: each CTA's sums over its stages
  __syncthreads();
  float* dump = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = (i >> 2) * RSTEP + arow + (i & 3);
    *reinterpret_cast<float4*>(dump + r * LDD + bcol_t) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    *reinterpret_cast<float4*>(dump + r * LDD + CSTEP + bcol_t) =
        make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
  }
  cluster.sync();

  // tile row r, columns c .. c + 3, each part times sg, added in part order
  const auto sum4 = [&](int r, int c, float sg) {
    const float4 v0 = *reinterpret_cast<const float4*>(
        cluster.map_shared_rank(dump, 0) + r * LDD + c);
    float4 v = make_float4(sg * v0.x, sg * v0.y, sg * v0.z, sg * v0.w);
    for (int p = 1; p < parts; ++p) {
      const float4 w = *reinterpret_cast<const float4*>(
          cluster.map_shared_rank(dump, p) + r * LDD + c);
      v.x = __fadd_rn(v.x, sg * w.x);
      v.y = __fadd_rn(v.y, sg * w.y);
      v.z = __fadd_rn(v.z, sg * w.z);
      v.w = __fadd_rn(v.w, sg * w.w);
    }
    return v;
  };
  const int per = (BM + parts - 1) / parts;
  const int r_begin = min(BM, part * per), r_end = min(BM, r_begin + per);

  if (EPI == RING_PEAK) {
    // a warp a row: lane l scans columns 4l .. 4l + 3 in order with a
    // strict >, then the lanes reduce keeping the smaller lag on equal values
    for (int r = r_begin + warp; r < r_end; r += WARPS) {
      const int row = row0 + r;
      int lo = 1, hi = 0;  // empty range for rows past R
      if (row < R) {
        const int b = (o.row_base + row) / o.bdiv;
        lo = o.lo[b];
        hi = o.hi[b];
      }
      const float4 v = sum4(r, lane * 4, 1.f);
      const float vv[4] = {v.x, v.y, v.z, v.w};
      float best = -CUDART_INF_F;
      int bidx = 0;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = col0 + lane * 4 + e;
        if (col >= lo && col <= hi && col < ncols && vv[e] > best) {
          best = vv[e];
          bidx = col;
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, best, off);
        const int oi = __shfl_xor_sync(0xffffffffu, bidx, off);
        if (ov > best || (ov == best && oi < bidx)) {
          best = ov;
          bidx = oi;
        }
      }
      if (lane == 0 && row < R) {
        o.part_val[part0 + row] = best;
        o.part_idx[part0 + row] = bidx;
      }
    }
  } else {
    // lanes along rows, 4 columns a lane: K-major stores, 4 rows contiguous
    const int nr = r_end - r_begin;
    for (int e = t; e < nr * (BN / 4); e += NT) {
      const int r = r_begin + e % nr, c = (e / nr) * 4;
      const int row = row0 + r, col = col0 + c;
      const float4 v = sum4(r, c, col >= o.neg_from ? -1.f : 1.f);
      if (row < R) {
        o.out[(size_t)col * o.ldo + row] = v.x;
        o.out[(size_t)(col + 1) * o.ldo + row] = v.y;
        o.out[(size_t)(col + 2) * o.ldo + row] = v.z;
        o.out[(size_t)(col + 3) * o.ldo + row] = v.w;
      }
    }
  }
  cluster.sync();  // no CTA leaves while another may read its shared memory
}

// ---- host side ---------------------------------------------------------------

// An (outer, inner) fp32 matrix, rows ld floats apart (ld a multiple of 4),
// read in boxes of BK x box_inner: A K-major (K, rows), or a B table.
inline bool encode_2d(EncodeTiled fn, CUtensorMap* map, const float* base,
                      int inner, int ld, int outer, int box_inner) {
  const cuuint64_t dims[2] = {(cuuint64_t)inner, (cuuint64_t)outer};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * sizeof(float)};
  const cuuint32_t box[2] = {(cuuint32_t)box_inner, (cuuint32_t)BK};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(base),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The tensor maps of A (K, rows) K-major, rows lda apart, and of two
// row-major (krows, bcols) B tables.  Returns 0, -1 (no tensor-map
// encoder) or -2 (a map was refused).
inline int encode_ring(CUtensorMap (&maps)[3], const float* a, int rows,
                       int lda, int K, const float* b0, const float* b1,
                       int krows, int bcols) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return -1;
  if (!encode_2d(fn, &maps[0], a, rows, lda, K, BM) ||
      !encode_2d(fn, &maps[1], b0, bcols, bcols, krows, BN) ||
      !encode_2d(fn, &maps[2], b1, bcols, bcols, krows, BN))
    return -2;
  return 0;
}

// The launch of ring_tile_kernel<EPI>: a grid of row tiles x ncols /
// BN x parts, clusters of (1, 1, parts), parts = ceil(K / kpart).
inline cudaLaunchConfig_t ring_config(int R, int K, int kpart, int ncols,
                                      cudaStream_t stream,
                                      cudaLaunchAttribute* attr) {
  const int parts = (K + kpart - 1) / kpart;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((R + BM - 1) / BM, ncols / BN, parts);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = SMEM;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = 1;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = parts;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Sets the kernel's shared-memory attribute (on every call: a flag kept in
// a static of this template would be one object in every library that
// includes the header).
template <int EPI>
inline cudaError_t ring_attributes() {
  return cudaFuncSetAttribute(ring_tile_kernel<EPI>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              SMEM);
}

// Launches the tile on the operands of `maps` (encode_ring); kpart a
// multiple of BK with at most MAX_PARTS parts; ncols a multiple of BN.
// Returns the cudaError_t of the launch: a cluster shape the card refuses
// fails here, and nothing else runs in its place.
template <int EPI>
int launch_ring(const CUtensorMap (&maps)[3], const RingOut& o, int R, int K,
                int kpart, int ncols, int ksplit, int nsplit, int kvalid,
                cudaStream_t stream) {
  if (kpart <= 0 || kpart % BK != 0 || (K + kpart - 1) / kpart > MAX_PARTS ||
      ncols % BN != 0 || kvalid % BK != 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = ring_attributes<EPI>();
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      ring_config(R, K, kpart, ncols, stream, &attr);
  err = cudaLaunchKernelEx(&cfg, ring_tile_kernel<EPI>, maps[0], maps[1],
                           maps[2], o, R, K, kpart, ncols, ksplit, nsplit,
                           kvalid);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// How many clusters of `parts` CTAs of ring_tile_kernel<EPI> the card can
// hold at once (cudaOccupancyMaxActiveClusters), or -(cudaError_t).
template <int EPI>
int max_active_clusters(int parts) {
  cudaError_t err = ring_attributes<EPI>();
  if (err != cudaSuccess) return -(int)err;
  cudaLaunchAttribute attr;
  // a grid of 132 x parts CTAs: the count depends on the cluster shape
  const cudaLaunchConfig_t cfg = ring_config(
      132 * BM, parts * BK, BK, BN, nullptr, &attr);
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(&n, ring_tile_kernel<EPI>, &cfg);
  return err != cudaSuccess ? -(int)err : n;
}

}  // namespace ring
}  // namespace nbls
