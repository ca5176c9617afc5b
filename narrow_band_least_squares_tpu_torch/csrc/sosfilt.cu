// sosfilt for Hopper (sm_90a): the exact time-domain recurrence of a
// second-order-section IIR cascade, one thread per row.
//
// This is the port's own kernel, not the counterpart of a TPU kernel: the
// JAX package computes the same recurrence with lax.scan
// (narrow_band_least_squares_tpu/ops/filters.py::sosfilt_scan) as the
// cross-check of its frequency-domain filter bank.  In PyTorch a loop over
// the samples would launch some ten small operations a sample and section
// (10^5 and more a row of 24,000 samples), so the loop runs here instead.
//
// For every row r of x (N, T) and sample t, sections s = 0 .. S-1 in turn,
// transposed direct-form II, in the JAX package's order of operations and
// with the roundings of its compiled lax.scan:
//     ys       = fma(b0, y, z1[s])
//     z1[s]    = fma(b1, y, -(a1 * ys)) + z2[s]
//     z2[s]    = fma(b2, y, -(a2 * ys))
//     y        = ys
// XLA's CPU backend contracts each statement's first product (the one with
// the section's input y) into the add or subtract that takes it; a1 * ys
// and a2 * ys are rounded (scripts/xla_contractions.py --sosfilt reads
// this from the optimized IR for 1, 2 and 4 sections and the zero-phase
// pair).  __fmaf_rn there, __fmul_rn / __fadd_rn elsewhere (nvcc never
// contracts those), so the result equals the plain PyTorch loop on the CPU
// bit for bit.  sos rows are (b0, b1, b2, a0, a1, a2) with a0 = 1.
//
// What bounds it: latency.  The recurrence is sequential in t, so a row is
// a chain of T * S dependent steps; the chain through a section is
// z1 -> ys (one fma) -> a1 * ys (a multiply) -> z1' (an fma and an add):
// four dependent operations of ~4 cycles each.  The bytes (x read once, y
// written once) and the operations are tiny for the card.  Rows run in parallel threads.  The
// section count is a template parameter (one kernel per count up to
// MAX_SECTIONS), so the coefficients and the state of every section sit in
// registers and no instruction is spent on sections that do not exist;
// a row's samples arrive CHUNK at a time, the next chunk's loads in flight
// while the current chunk runs through the cascade, so the chain waits on
// no load.
//
// Plain C interface, bound from Python with ctypes; built with
//   nvcc -gencode=arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared
// by narrow_band_least_squares_tpu_torch/ops/kernels/_build.py.

#include <cuda_runtime.h>

namespace {

constexpr int MAX_SECTIONS = 16;
constexpr int THREADS = 128;
constexpr int CHUNK = 16;  // samples a thread loads ahead

// One sample through the cascade: the JAX package's order of operations
// and contractions.
template <int S>
__device__ __forceinline__ float cascade(float v, const float (&c)[S][6],
                                         float (&z1)[S], float (&z2)[S]) {
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const float ys = __fmaf_rn(c[s][0], v, z1[s]);
    z1[s] = __fadd_rn(__fmaf_rn(c[s][1], v, -__fmul_rn(c[s][4], ys)), z2[s]);
    z2[s] = __fmaf_rn(c[s][2], v, -__fmul_rn(c[s][5], ys));
    v = ys;
  }
  return v;
}

template <int S>
__global__ void __launch_bounds__(THREADS)
sosfilt_kernel(const float* __restrict__ x, float* __restrict__ y,
               const float* __restrict__ sos, int N, long long T) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= N) return;
  float c[S][6], z1[S], z2[S];
#pragma unroll
  for (int s = 0; s < S; ++s) {
#pragma unroll
    for (int k = 0; k < 6; ++k) c[s][k] = __ldg(sos + 6 * s + k);
    z1[s] = z2[s] = 0.f;
  }
  const float* xr = x + (size_t)r * T;
  float* yr = y + (size_t)r * T;
  const long long whole = T / CHUNK * CHUNK;
  float cur[CHUNK], nxt[CHUNK] = {};
  if (whole > 0) {
#pragma unroll
    for (int i = 0; i < CHUNK; ++i) cur[i] = __ldg(xr + i);
  }
  for (long long t = 0; t < whole; t += CHUNK) {
    if (t + CHUNK < whole) {
#pragma unroll
      for (int i = 0; i < CHUNK; ++i) nxt[i] = __ldg(xr + t + CHUNK + i);
    }
#pragma unroll
    for (int i = 0; i < CHUNK; ++i) yr[t + i] = cascade<S>(cur[i], c, z1, z2);
#pragma unroll
    for (int i = 0; i < CHUNK; ++i) cur[i] = nxt[i];
  }
  for (long long t = whole; t < T; ++t) yr[t] = cascade<S>(__ldg(xr + t), c, z1, z2);
}

// The kernel of `sections` sections, S and up.
template <int S>
int launch(int sections, const float* x, float* y, const float* sos, int N,
           long long T, cudaStream_t stream) {
  if (sections != S) {
    if constexpr (S < MAX_SECTIONS)
      return launch<S + 1>(sections, x, y, sos, N, T, stream);
    return (int)cudaErrorInvalidValue;
  }
  sosfilt_kernel<S><<<(N + THREADS - 1) / THREADS, THREADS, 0, stream>>>(x, y, sos,
                                                                          N, T);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Sections a launch takes at most (one kernel per count).
int nbls_sosfilt_max_sections(void) { return MAX_SECTIONS; }

// y (N, T) = the cascade sos (S, 6) over each row of x (N, T), on `stream`;
// float32, contiguous.  Returns the cudaError_t of the launch.
int nbls_sosfilt(const float* x, float* y, const float* sos, int S, int N,
                 long long T, cudaStream_t stream) {
  if (S <= 0 || N <= 0 || T <= 0) return (int)cudaErrorInvalidValue;
  return launch<1>(S, x, y, sos, N, T, stream);
}

}  // extern "C"
