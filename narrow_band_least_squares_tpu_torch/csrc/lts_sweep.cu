// lts_sweep for Hopper (sm_90a): the LTS sweep's multiply-adds rounded as
// the JAX package's jitted lts_solve rounds them on the CPU.
//
// The port's own kernels, not the counterpart of a TPU kernel: the JAX
// package's sweep (narrow_band_least_squares_tpu/ops/lts.py, ops/solve.py
// ::masked_refit) is plain XLA, and XLA's CPU backend contracts a multiply
// whose product feeds an add in the same basic block into a fused
// multiply-add.  LTS flags hang on the last bits of the squared residuals,
// so these kernels compute the same roundings: __fmaf_rn where XLA
// contracts, __fmul_rn / __fadd_rn / __fsub_rn / __fdiv_rn everywhere else
// (nvcc never contracts those).  Four entry points:
//
//   nbls_lts_residuals2  r2[row, p] = r * r,  r = tau[trow, p] -
//                        fma(X[p,1], s[row,1], X[p,0] * s[row,0]),
//                        trow = row / Q (the candidates of one window share
//                        its delays); one thread an output;
//   nbls_lts_residuals2_lag  the same with r = fma(lag[trow, p], inv_fs,
//                        -fma(X[p,1], s[row,1], X[p,0] * s[row,0])): the
//                        delay lag * inv_fs unrounded, where the JAX
//                        package's one-band programs fuse the delays'
//                        product into the residual
//                        (ops/lts.py::delay_contracted); float32 only;
//   nbls_lts_refit       the masked 2x2 normal-equation solve of the 0/1
//                        weights w (rows, P): five halving trees over the
//                        next power of two, zero-padded (m00 = w X0 . X0,
//                        m01 = w X0 . X1, m11 = w X1 . X1, b0 = w tau . X0,
//                        b1 = w tau . X1), whose first level is
//                        fma(u[i], v[i], u[i+h] * v[i+h]) where bit k of
//                        `contract` is set for sum k, else u[i] * v[i] +
//                        u[i+h] * v[i+h]; later levels plain adds; then
//                        det = fma(m00, m11, -(m01 m01)), the numerators
//                        fma(b0, m11, -(b1 m01)) and fma(b1, m00, -(b0 m01)),
//                        one division each, zeros where |det| <= eps; one
//                        thread a row, so the sums follow the tree, not the
//                        hardware;
//   nbls_lts_elemental   s[trow, q, i] = fma(Ainv[q,i,1], t1, Ainv[q,i,0] *
//                        t0), t = tau[trow, cand[q]]; one thread a
//                        (window, candidate).
//
// Values are float32, bfloat16 or float16 in memory (dtype code 0, 1, 2).
// In a narrower type every operation is taken in float32 and rounded to the
// storage type, as PyTorch rounds each operation of a narrow tensor, and
// nothing is contracted: the JAX package's narrow dtypes round where XLA's
// fusions end, which the port matches only within their rounding
// (tests/test_torch_dtypes.py).
//
// What bounds it: bytes and launches.  Each output costs a few operations
// against 8-16 bytes of memory traffic; the refit reads its row's weights
// and delays five times, from L1.  The canonical sweep (632 windows x 378
// candidates x 28 equations) moves ~27 MB a residual pass.  A row of up to
// 64 equations keeps its tree in registers (the capacity is a template
// parameter); longer rows, up to MAX_HALF * 2, use local memory.
//
// Plain C interface, bound from Python with ctypes; built with
//   nvcc -gencode=arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared
// by narrow_band_least_squares_tpu_torch/ops/kernels/_build.py.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_HALF = 512;  // rows of at most 1024 equations
constexpr int REG_HALF = 32;   // trees up to this half width unroll into registers

template <class T> struct Num;
template <> struct Num<float> {
  static constexpr bool kContracts = true;
  static __device__ __forceinline__ float ld(float v) { return v; }
  static __device__ __forceinline__ float rn(float v) { return v; }
  static __device__ __forceinline__ float st(float v) { return v; }
};
template <> struct Num<__nv_bfloat16> {
  static constexpr bool kContracts = false;
  static __device__ __forceinline__ float ld(__nv_bfloat16 v) { return __bfloat162float(v); }
  static __device__ __forceinline__ float rn(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
  static __device__ __forceinline__ __nv_bfloat16 st(float v) { return __float2bfloat16_rn(v); }
};
template <> struct Num<__half> {
  static constexpr bool kContracts = false;
  static __device__ __forceinline__ float ld(__half v) { return __half2float(v); }
  static __device__ __forceinline__ float rn(float v) {
    return __half2float(__float2half_rn(v));
  }
  static __device__ __forceinline__ __half st(float v) { return __float2half_rn(v); }
};

// One operation each, rounded to T: values are T's values held in float.
// A contraction site is one float32 fused multiply-add; in a narrower T it
// is a multiply and an add, each rounded to T.
template <class T> struct Ops {
  using N = Num<T>;
  static __device__ __forceinline__ float mul(float a, float b) { return N::rn(__fmul_rn(a, b)); }
  static __device__ __forceinline__ float add(float a, float b) { return N::rn(__fadd_rn(a, b)); }
  static __device__ __forceinline__ float sub(float a, float b) { return N::rn(__fsub_rn(a, b)); }
  static __device__ __forceinline__ float div(float a, float b) { return N::rn(__fdiv_rn(a, b)); }
  static __device__ __forceinline__ float fma(float a, float b, float c) {
    if constexpr (N::kContracts) return __fmaf_rn(a, b, c);
    else return add(mul(a, b), c);
  }
};

template <class T>
__global__ void __launch_bounds__(THREADS)
residuals2_kernel(const T* __restrict__ tau, const T* __restrict__ X,
                  const T* __restrict__ s, T* __restrict__ out, long long n, int Q,
                  int P) {
  using N = Num<T>;
  using O = Ops<T>;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const int p = (int)(i % P);
    const long long row = i / P;
    const float xs = O::fma(N::ld(X[2 * p + 1]), N::ld(s[2 * row + 1]),
                            O::mul(N::ld(X[2 * p]), N::ld(s[2 * row])));
    const float r = O::sub(N::ld(tau[(row / Q) * P + p]), xs);
    out[i] = N::st(O::mul(r, r));
  }
}

__global__ void __launch_bounds__(THREADS)
residuals2_lag_kernel(const float* __restrict__ lag, float inv_fs,
                      const float* __restrict__ X, const float* __restrict__ s,
                      float* __restrict__ out, long long n, int Q, int P) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const int p = (int)(i % P);
    const long long row = i / P;
    const float xs = __fmaf_rn(X[2 * p + 1], s[2 * row + 1], __fmul_rn(X[2 * p], s[2 * row]));
    const float r = __fmaf_rn(lag[(row / Q) * P + p], inv_fs, -xs);
    out[i] = __fmul_rn(r, r);
  }
}

// The first level of a halving tree over 2 * half leaves (zero past P):
// x[i] = u(i) v(i) + u(i + half) v(i + half), one rounding or three.
template <class T, class Leaf>
__device__ __forceinline__ float first_level(int i, int half, int P, bool contract,
                                             Leaf leaf) {
  using O = Ops<T>;
  const float2 lo = leaf(i);
  const bool in = i + half < P;
  const float2 up = leaf(in ? i + half : i);
  const float hi = in ? O::mul(up.x, up.y) : 0.f;
  return contract ? O::fma(lo.x, lo.y, hi) : O::add(O::mul(lo.x, lo.y), hi);
}

// The halving tree's later levels: x[i] += x[i + H] for H, H/2, ..., 1.
template <class T, int H, int N>
__device__ __forceinline__ void reduce_levels(float (&x)[N]) {
#pragma unroll
  for (int i = 0; i < H; ++i) x[i] = Ops<T>::add(x[i], x[i + H]);
  if constexpr (H > 1) reduce_levels<T, H / 2>(x);
}

// sum_p u(p) v(p) as the halving tree over the next power of two, zero
// past P, its first level contracted or not; CAP is the half width.  Up to
// REG_HALF the tree unrolls into registers, above it it runs in local
// memory.
template <class T, int CAP, class Leaf>
__device__ __forceinline__ float tree_dot(int P, int half, bool contract, Leaf leaf) {
  using O = Ops<T>;
  float x[CAP];
  if constexpr (CAP <= REG_HALF) {  // half == CAP
#pragma unroll
    for (int i = 0; i < CAP; ++i) x[i] = first_level<T>(i, CAP, P, contract, leaf);
    if constexpr (CAP > 1) reduce_levels<T, CAP / 2>(x);
  } else {
#pragma unroll 1
    for (int i = 0; i < half; ++i) x[i] = first_level<T>(i, half, P, contract, leaf);
#pragma unroll 1
    for (int m = half / 2; m >= 1; m /= 2) {
#pragma unroll 1
      for (int i = 0; i < m; ++i) x[i] = O::add(x[i], x[i + m]);
    }
  }
  return x[0];
}

template <class T, int CAP>
__global__ void __launch_bounds__(THREADS)
refit_kernel(const T* __restrict__ tau, const T* __restrict__ X,
             const T* __restrict__ w, T* __restrict__ out, long long rows, int q,
             int P, int half, float eps, int contract) {
  using N = Num<T>;
  using O = Ops<T>;
  const long long row = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (row >= rows) return;
  const T* wr = w + row * P;
  const T* tr = tau + (row / q) * P;
  // leaves: u = w X0 (m00, m01), w X1 (m11), w tau (b0, b1); v = X column
  auto wx = [&](int k, int c) { return O::mul(N::ld(wr[k]), N::ld(X[2 * k + c])); };
  auto wt = [&](int k) { return O::mul(N::ld(wr[k]), N::ld(tr[k])); };
  float m00, m01, m11, b0, b1;
  if constexpr (CAP == 0) {  // P == 1: one product, no tree
    const float x0 = N::ld(X[0]), x1 = N::ld(X[1]);
    m00 = O::mul(wx(0, 0), x0);
    m01 = O::mul(wx(0, 0), x1);
    m11 = O::mul(wx(0, 1), x1);
    b0 = O::mul(wt(0), x0);
    b1 = O::mul(wt(0), x1);
  } else {
    m00 = tree_dot<T, CAP>(P, half, contract & 1, [&](int k) {
      return make_float2(wx(k, 0), N::ld(X[2 * k])); });
    m01 = tree_dot<T, CAP>(P, half, contract & 2, [&](int k) {
      return make_float2(wx(k, 0), N::ld(X[2 * k + 1])); });
    m11 = tree_dot<T, CAP>(P, half, contract & 4, [&](int k) {
      return make_float2(wx(k, 1), N::ld(X[2 * k + 1])); });
    b0 = tree_dot<T, CAP>(P, half, contract & 8, [&](int k) {
      return make_float2(wt(k), N::ld(X[2 * k])); });
    b1 = tree_dot<T, CAP>(P, half, contract & 16, [&](int k) {
      return make_float2(wt(k), N::ld(X[2 * k + 1])); });
  }
  const float det = O::fma(m00, m11, -O::mul(m01, m01));
  const bool ok = fabsf(det) > eps;
  const float safe = ok ? det : 1.f;
  const float s0 = O::div(O::fma(b0, m11, -O::mul(b1, m01)), safe);
  const float s1 = O::div(O::fma(b1, m00, -O::mul(b0, m01)), safe);
  out[2 * row] = N::st(ok ? s0 : 0.f);
  out[2 * row + 1] = N::st(ok ? s1 : 0.f);
}

template <class T>
__global__ void __launch_bounds__(THREADS)
elemental_kernel(const T* __restrict__ tau, const long long* __restrict__ cand,
                 const T* __restrict__ A, T* __restrict__ out, long long n, int Q,
                 int P) {
  using N = Num<T>;
  using O = Ops<T>;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const int q = (int)(i % Q);
    const T* tr = tau + (i / Q) * P;
    const float t0 = N::ld(tr[cand[2 * q]]), t1 = N::ld(tr[cand[2 * q + 1]]);
    const T* a = A + 4 * q;
    out[2 * i] = N::st(O::fma(N::ld(a[1]), t1, O::mul(N::ld(a[0]), t0)));
    out[2 * i + 1] = N::st(O::fma(N::ld(a[3]), t1, O::mul(N::ld(a[2]), t0)));
  }
}

unsigned grid_for(long long n) {
  const long long blocks = (n + THREADS - 1) / THREADS;
  return (unsigned)(blocks < (1LL << 30) ? blocks : (1LL << 30));
}

template <class T>
int residuals2(const void* tau, const void* X, const void* s, void* out, long long rows_tau,
               int Q, int P, cudaStream_t stream) {
  const long long n = rows_tau * Q * P;
  residuals2_kernel<T><<<grid_for(n), THREADS, 0, stream>>>(
      (const T*)tau, (const T*)X, (const T*)s, (T*)out, n, Q, P);
  return (int)cudaGetLastError();
}

template <class T, int CAP>
int refit_cap(int half, const void* tau, const void* X, const void* w, void* out,
              long long rows, int q, int P, float eps, int contract, cudaStream_t stream) {
  if (half > CAP) {
    if constexpr (CAP < MAX_HALF)
      return refit_cap<T, CAP == 0 ? 1 : 2 * CAP>(half, tau, X, w, out, rows, q, P, eps,
                                                  contract, stream);
    return (int)cudaErrorInvalidValue;
  }
  refit_kernel<T, CAP><<<grid_for(rows), THREADS, 0, stream>>>(
      (const T*)tau, (const T*)X, (const T*)w, (T*)out, rows, q, P, half, eps, contract);
  return (int)cudaGetLastError();
}

template <class T>
int elemental(const void* tau, const void* cand, const void* A, void* out, long long rows_tau,
              int Q, int P, cudaStream_t stream) {
  const long long n = rows_tau * Q;
  elemental_kernel<T><<<grid_for(n), THREADS, 0, stream>>>(
      (const T*)tau, (const long long*)cand, (const T*)A, (T*)out, n, Q, P);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// r2 (rows_tau, Q, P) of the fits s (rows_tau, Q, 2) to tau (rows_tau, P)
// through X (P, 2); contiguous, dtype code 0/1/2 (float32, bfloat16,
// float16).  Returns the cudaError_t of the launch.
int nbls_lts_residuals2(int dtype, const void* tau, const void* X, const void* s, void* out,
                        long long rows_tau, int Q, int P, cudaStream_t stream) {
  if (rows_tau <= 0 || Q <= 0 || P <= 0) return (int)cudaErrorInvalidValue;
  switch (dtype) {
    case 0: return residuals2<float>(tau, X, s, out, rows_tau, Q, P, stream);
    case 1: return residuals2<__nv_bfloat16>(tau, X, s, out, rows_tau, Q, P, stream);
    case 2: return residuals2<__half>(tau, X, s, out, rows_tau, Q, P, stream);
  }
  return (int)cudaErrorInvalidValue;
}

// r2 (rows_tau, Q, P) as nbls_lts_residuals2 for the delays lag (rows_tau,
// P) * inv_fs, the product contracted into each residual; float32.
int nbls_lts_residuals2_lag(const float* lag, float inv_fs, const float* X, const float* s,
                            float* out, long long rows_tau, int Q, int P,
                            cudaStream_t stream) {
  if (rows_tau <= 0 || Q <= 0 || P <= 0) return (int)cudaErrorInvalidValue;
  const long long n = rows_tau * Q * P;
  residuals2_lag_kernel<<<grid_for(n), THREADS, 0, stream>>>(lag, inv_fs, X, s, out, n, Q,
                                                             P);
  return (int)cudaGetLastError();
}

// s (rows, 2) of the weights w (rows, P); row r takes tau row r / q of tau
// (rows / q, P); bit k of `contract` contracts the first tree level of sum
// k (m00, m01, m11, b0, b1).  P <= 2 * MAX_HALF.
int nbls_lts_refit(int dtype, const void* tau, const void* X, const void* w, void* out,
                   long long rows, int q, int P, float eps, int contract,
                   cudaStream_t stream) {
  if (rows <= 0 || q <= 0 || P <= 0 || P > 2 * MAX_HALF) return (int)cudaErrorInvalidValue;
  const int half = P == 1 ? 0 : 1 << (31 - __builtin_clz(P - 1));
  switch (dtype) {
    case 0: return refit_cap<float, 0>(half, tau, X, w, out, rows, q, P, eps, contract, stream);
    case 1:
      return refit_cap<__nv_bfloat16, 0>(half, tau, X, w, out, rows, q, P, eps, contract,
                                         stream);
    case 2: return refit_cap<__half, 0>(half, tau, X, w, out, rows, q, P, eps, contract, stream);
  }
  return (int)cudaErrorInvalidValue;
}

// s (rows_tau, Q, 2) of the candidate pairs cand (Q, 2, int64) through
// Ainv (Q, 2, 2) on tau (rows_tau, P).
int nbls_lts_elemental(int dtype, const void* tau, const void* cand, const void* A, void* out,
                       long long rows_tau, int Q, int P, cudaStream_t stream) {
  if (rows_tau <= 0 || Q <= 0 || P <= 0) return (int)cudaErrorInvalidValue;
  switch (dtype) {
    case 0: return elemental<float>(tau, cand, A, out, rows_tau, Q, P, stream);
    case 1: return elemental<__nv_bfloat16>(tau, cand, A, out, rows_tau, Q, P, stream);
    case 2: return elemental<__half>(tau, cand, A, out, rows_tau, Q, P, stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
