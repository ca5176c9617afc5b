// pair_spectra for Hopper (sm_90a): the lag search's operand cs2, formed
// pair by pair straight from the forward DFT's two products.
//
// This is the port's own kernel, not the counterpart of a TPU kernel: the
// JAX package gathers the pairs' spectra and multiplies them in XLA
// (narrow_band_least_squares_tpu/ops/xcorr.py:214-220 and :374-381).  In
// PyTorch the same chain is four gathered copies of the spectra, four
// products, a sum, a difference, a cat and a zero pad: some ten writes and
// reads of a tensor the size of cs2 to produce one write of it.  Here every
// byte of cs2 is written once and the spectra are read once.
//
// Inputs, float32 and contiguous: re = flat @ Cf and s = flat @ Sf, each
// (N, C, K) (N windows, C elements, K bins), and the (P, 2) int64 pairs
// (i, j), indexed as PyTorch indexes: an index in [-C, 0) counts from the
// end, and one outside [-C, C) traps, which fails the launch as PyTorch's
// device-side assert fails the eager chain's gather.  The spectrum of element c is F_c = re_c - i s_c (the JAX
// package's ImF = -s; the negation is folded in here).  Output (N * P,
// width), row n * P + p:
//     columns [0, K)      Re(F_j conj F_i) = re_j re_i + s_j s_i
//     columns [K, 2K)     Im(F_j conj F_i) = re_j s_i - s_j re_i
//     columns [2K, width) 0
// Each product and each sum is rounded on its own (__fmul_rn, __fadd_rn,
// __fsub_rn; nvcc never contracts those), as eager PyTorch rounds
// ReJ * ReI + ImJ * ImI and ImJ * ReI - ReJ * ImI with ImF = -s.  Negation
// is exact and round-to-nearest symmetric, so (-a)(-b) has the bits of ab
// and (-p1) - (-p2) those of p2 - p1, signed zeros included: cs2 equals the
// eager chain bit for bit.
//
// What bounds it: bytes (about 0.3 operations a byte).  One block takes one
// window n and a chunk of CW output columns.  It stages the bins those
// columns read (column c reads bin c, or c - K in the Im half) for all C
// elements, re and s, in shared memory, reading each from HBM once (the
// block of the Im half of the same bins runs next to it, so its read finds
// L2), then writes the chunk of every pair's row: V consecutive columns a
// thread, 16-byte stores where width is a multiple of 4.  The grid is
// windows x chunks in one dimension, a window's chunks adjacent.  CW is
// 64 columns, halved until the staging fits in 48 KB (C up to 96 at 64).
// 64 columns and 128 threads were the fastest of the shapes tried on the
// benchmark's buckets (C = 8; 128 to 512 threads, 32 to 256 columns) on an
// H100: 0.072 ms a canonical step against 0.073 to 0.090 ms, and within
// 0.5% of the fastest (32 columns) in third octaves.
//
// Plain C interface, bound from Python with ctypes; built with
//   nvcc -gencode=arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared
// by narrow_band_least_squares_tpu_torch/ops/kernels/_build.py.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;
constexpr int CW_MAX = 64;                // output columns a block
constexpr int CW_MIN = 4;
constexpr int SMEM_BYTES = 48 * 1024;     // staging, re and s of C elements
constexpr int MAX_ELEMENTS = SMEM_BYTES / (2 * CW_MIN * (int)sizeof(float));

// V consecutive columns: loaded from the staging, stored to cs2 (V = 4:
// 16-byte accesses, both addresses 16-byte aligned).
template <int V>
struct Cols {
  float v[V];
  __device__ __forceinline__ void load(const float* p) {
    if constexpr (V == 4) {
      const float4 q = *reinterpret_cast<const float4*>(p);
      v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
    } else {
#pragma unroll
      for (int t = 0; t < V; ++t) v[t] = p[t];
    }
  }
  __device__ __forceinline__ void store(float* p) const {
    if constexpr (V == 4) {
      *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
#pragma unroll
      for (int t = 0; t < V; ++t) p[t] = v[t];
    }
  }
};

// V columns a thread (4 where width % 4 == 0 and out is 16-byte aligned).
template <int V>
__global__ void __launch_bounds__(THREADS)
pair_spectra_kernel(const float* __restrict__ re, const float* __restrict__ s,
                    const long long* __restrict__ pairs, float* __restrict__ out,
                    int C, int P, int K, int width, int cw_log2, int chunks) {
  extern __shared__ float4 stage4[];      // [2][C][CW]: re, then s
  float* sre = reinterpret_cast<float*>(stage4);
  const int CW = 1 << cw_log2;
  float* ss = sre + C * CW;
  const long long n = blockIdx.x / chunks;
  const int c0 = (int)(blockIdx.x % chunks) * CW;
  const size_t in0 = (size_t)n * C * K;

  // the bins that columns [c0, c0 + CW) read, for every element
  for (int e = threadIdx.x; e < C * CW; e += THREADS) {
    const int i = e >> cw_log2;
    const int c = c0 + (e & (CW - 1));
    if (c < 2 * K) {
      const size_t at = in0 + (size_t)i * K + (c < K ? c : c - K);
      sre[e] = __ldg(re + at);
      ss[e] = __ldg(s + at);
    }
  }
  __syncthreads();

  const int g_log2 = cw_log2 - (V == 4 ? 2 : 0);   // column groups a row
  const int groups = 1 << g_log2;
  for (int e = threadIdx.x; e < P * groups; e += THREADS) {
    const int p = e >> g_log2;
    const int cc = (e & (groups - 1)) * V;
    const int c = c0 + cc;
    if (c >= width) continue;
    Cols<V> ri, si, rj, sj, o;
    if (c < 2 * K) {    // staged columns past 2K are never used
      long long i = __ldg(pairs + 2 * p), j = __ldg(pairs + 2 * p + 1);
      // PyTorch's indexing: [-C, 0) counts from the end, anything outside
      // [-C, C) ends the launch with an error (a device-side assert there)
      if (i < 0) i += C;
      if (j < 0) j += C;
      if ((unsigned long long)i >= (unsigned long long)C ||
          (unsigned long long)j >= (unsigned long long)C)
        __trap();
      ri.load(sre + i * CW + cc);
      si.load(ss + i * CW + cc);
      rj.load(sre + j * CW + cc);
      sj.load(ss + j * CW + cc);
    }
#pragma unroll
    for (int t = 0; t < V; ++t) {
      const int col = c + t;
      float x = 0.f;
      if (col < K)
        x = __fadd_rn(__fmul_rn(rj.v[t], ri.v[t]), __fmul_rn(sj.v[t], si.v[t]));
      else if (col < 2 * K)
        x = __fsub_rn(__fmul_rn(rj.v[t], si.v[t]), __fmul_rn(sj.v[t], ri.v[t]));
      o.v[t] = x;
    }
    o.store(out + ((size_t)n * P + p) * width + c);
  }
}

}  // namespace

extern "C" {

// Elements a launch takes at most (the staging of CW_MIN columns in 48 KB).
int nbls_pair_spectra_max_elements(void) { return MAX_ELEMENTS; }

// out (N * P, width) = the cross-spectra of `pairs` (P, 2) from re and s
// (N, C, K), on `stream` (module comment).  Returns the cudaError_t of the
// launch; cudaErrorInvalidValue for shapes it does not take.
int nbls_pair_spectra(const float* re, const float* s, const long long* pairs,
                      float* out, long long N, int C, int P, int K, int width,
                      cudaStream_t stream) {
  if (N <= 0 || C <= 0 || C > MAX_ELEMENTS || P <= 0 || K < 0 || width <= 0 ||
      (long long)width < 2LL * K)
    return (int)cudaErrorInvalidValue;
  int cw = CW_MAX, cw_log2 = 0;
  while (cw > CW_MIN && 2 * C * cw * (int)sizeof(float) > SMEM_BYTES) cw /= 2;
  while ((1 << cw_log2) < cw) ++cw_log2;
  const long long chunks = (width + cw - 1) / cw;
  const long long blocks = N * chunks;
  if (blocks >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)2 * C * cw * sizeof(float);
  if (width % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0)
    pair_spectra_kernel<4><<<(unsigned)blocks, THREADS, smem, stream>>>(
        re, s, pairs, out, C, P, K, width, cw_log2, (int)chunks);
  else
    pair_spectra_kernel<1><<<(unsigned)blocks, THREADS, smem, stream>>>(
        re, s, pairs, out, C, P, K, width, cw_log2, (int)chunks);
  return (int)cudaGetLastError();
}

}  // extern "C"
