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
// (nvcc never contracts those).  Six entry points:
//
//   nbls_lts_final       the final subset of a solve in one launch, one warp
//                        a window (P <= 64): the first minimum of the
//                        candidates' objectives, the ranks of its fit's
//                        squared residuals, the refit of the h smallest,
//                        sigma_tau and the uncertainty ellipse; its
//                        arithmetic is that of
//                        ops/kernels/lts_sweep.py::final_reference, bit for
//                        bit (each operation rounded on its own outside the
//                        residuals and the refit, fixed-tree sums);
//   nbls_lts_sweep       the candidate sweep of one block of candidates in
//                        one launch: per (window, candidate) row, n_steps
//                        C-steps (residuals, rank keys, ranks by
//                        comparison, weights rank < h, the five-tree
//                        refit), then the trimmed objective (ranks again,
//                        the tree over sel * r2, NaN -> inf) when asked;
//                        everything in registers or shared memory, only
//                        s (rows, 2) and obj (rows) written.  Its
//                        arithmetic is that of the four below, composed as
//                        ops/kernels/lts_sweep.py::sweep_reference composes
//                        their plain versions, bit for bit;
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
// What bounds the four passes: bytes and launches.  Each output costs a
// few operations against 8-16 bytes of memory traffic; the refit reads its
// row's weights and delays five times, from L1.  The canonical sweep (632
// windows x 378 candidates x 28 equations) moves ~27 MB a residual pass.  A
// row of up to 64 equations keeps its tree in registers (the capacity is a
// template parameter); longer rows, up to MAX_HALF * 2, use local memory.
//
// What bounds nbls_lts_sweep: operations.  Per row it reads 2 slowness
// values and writes 3; its window's delays and the co-array are staged in
// shared memory once a block.  The work is the ranks of the rank passes
// (n_steps, and one for the objective) and the refit's trees; the bound
// counts the ranks as P (P - 1) / 2 comparisons a pass, each unordered
// pair of keys once, at 64 compares an SM a clock.  Three routes,
// chosen by P alone (and the dtype):
//
//   thread  float32 rows of P = 3, 6, 10, 15, 21, 28 or 36 equations (the
//           co-arrays of 3 to 9 elements; P a template parameter): one
//           thread a (window, candidate) row, a block of ROW_BLOCK
//           candidates of one window (the grid is windows x ceil(Q /
//           ROW_BLOCK) blocks).  The row's P rank keys and P ranks stay in
//           registers, and each unordered pair of keys is compared once:
//           rank_i starts at i, and for a < b, c = (k_b < k_a) adds c to
//           rank_a and takes it from rank_b (b counts against a iff k_b <
//           k_a, a against b iff k_a <= k_b: the (key, index) order).  The
//           keys are the values as floats (NaN as +inf), whose `<` is
//           rank_key's order, and the counts are floats (exact): a pair
//           is one FSET and two FADDs in the SASS, most of them on the
//           float pipe, where integer counts took three operations of
//           the half-rate integer pipe.  A pass whose ranked
//           and counted-against keys differ (delay roles) counts all P * P
//           ordered pairs with `before`, the counted-against keys in a
//           column of shared memory a thread.  The five trees' first
//           levels are taken in one sweep of the rows and the trees
//           reduced in registers, zero padding folded at compile time;
//   warp    any other P <= 64: one warp a row (lane k owns equations k and
//           k + 32; a block of 8 warps takes 8 candidates of one window, so
//           the grid is windows x ceil(Q / 8) blocks and the last group of
//           a window may leave warps idle); keys go through the warp's row
//           of shared memory and each lane counts its own elements' ranks;
//           a tree's level of half width 32 runs inside the lane, the lower
//           levels with __shfl_down_sync, its first level's operands
//           shuffled before the fused multiply-add;
//   block   64 < P <= MAX_P: one block a row, the row and its trees in
//           shared memory.
//
// Every route pairs each sum as the plain version's halving tree does
// (float addition commutes: which lane adds changes no bit), so the three
// give the same bits.  bfloat16 and float16 take the warp route at every P
// <= 64: thread-route instances for them would lengthen the build, and no
// LTS run of the canonical plans sweeps in a narrow dtype.
//
// What bounds nbls_lts_final: one warp's dependent chain and the launch.
// It reads each window's K objectives once (~1 MB at the canonical 632
// windows x 378 candidates) and writes a few values a window, so its byte
// bound is a fraction of a microsecond; with a few thousand windows at
// most, the time is the chain of one window: the strided minimum and its
// five shuffles, one rank pass, the refit's trees, three more sums and
// some thirty rounded operations of the ellipse in lane 0.  A window is
// spread over 32 lanes to shorten that chain, where the sweep, with
// hundreds of thousands of rows, gives each row one thread.  It replaces
// the ~95 small launches that computed the same values one operation at a
// time, each writing its result to memory and reading its inputs back.
//
// Plain C interface, bound from Python with ctypes; built with
//   nvcc -gencode=arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared
// by narrow_band_least_squares_tpu_torch/ops/kernels/_build.py.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <type_traits>

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
  static __device__ __forceinline__ float sqrt(float a) { return N::rn(__fsqrt_rn(a)); }
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

// The refit's 2x2 solve from its five sums: det = fma(m00, m11, -(m01
// m01)), the numerators fma(b0, m11, -(b1 m01)) and fma(b1, m00, -(b0
// m01)), one division each, zeros where |det| <= eps.
template <class T>
__device__ __forceinline__ float2 solve2(float m00, float m01, float m11, float b0, float b1,
                                         float eps) {
  using O = Ops<T>;
  const float det = O::fma(m00, m11, -O::mul(m01, m01));
  const bool ok = fabsf(det) > eps;
  const float safe = ok ? det : 1.f;
  const float s0 = O::div(O::fma(b0, m11, -O::mul(b1, m01)), safe);
  const float s1 = O::div(O::fma(b1, m00, -O::mul(b0, m01)), safe);
  return make_float2(ok ? s0 : 0.f, ok ? s1 : 0.f);
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
  const float2 sol = solve2<T>(m00, m01, m11, b0, b1, eps);
  out[2 * row] = N::st(sol.x);
  out[2 * row + 1] = N::st(sol.y);
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

// ---------------------------------------------------------------------------
// nbls_lts_sweep: C-steps and the trimmed objective, one launch a block of
// candidates
// ---------------------------------------------------------------------------

constexpr unsigned FULL_MASK = 0xffffffffu;
constexpr int MAX_P = 2 * MAX_HALF;
constexpr int SWEEP_WARPS = 8;     // warp route: candidates of one window a block
constexpr int WARP_P = 64;         // warp route: rows of at most this many equations
constexpr int ROW_THREADS = 128;   // block route: threads a row
constexpr int ROW_BLOCK = 128;     // thread route: candidates of one window a block
// route argument of nbls_lts_sweep: by P (what the Python wrapper passes),
// or never the thread route (the warp route at every P <= 64, for comparing
// the two on the card)
constexpr int ROUTE_BY_P = 0, ROUTE_NO_THREAD = 1;
// the route nbls_lts_sweep launched, written to its `launched`
// (ops/kernels/lts_sweep.py::ROUTES)
constexpr int LAUNCHED_THREAD = 0, LAUNCHED_WARP = 1, LAUNCHED_BLOCK = 2;

// Which squared residuals take the unrounded delay lag * inv_fs
// (ops/kernels/lts_sweep.py::ROLES): the C-steps' ranked keys (i) and the
// keys they are counted against (j); the objective's i and j, and the
// halves lo (index < half) and hi of its tree's leaves.
constexpr int ROLE_STEP_I = 1, ROLE_STEP_J = 2, ROLE_OBJ_I = 4, ROLE_OBJ_J = 8,
              ROLE_LO = 16, ROLE_HI = 32;

struct SweepArgs {
  const void* tau;     // (rows_tau, P)
  const void* X;       // (P, 2)
  const void* s_in;    // (rows_tau * Q, 2)
  const float* lag;    // (rows_tau, P) or null when roles == 0
  float inv_fs;
  void* s_out;         // (rows_tau * Q, 2)
  void* obj;           // (rows_tau * Q) or null: no objective
  long long rows_tau;
  int Q, P, h, n_steps, contract, roles;
  float eps;
};

// The rank key of a value: its float32 bits as a monotone int32, NaN as
// +inf and -0 as +0 (ops/kernels/lts_sweep.py::rank_keys, whose int64 key
// adds the index: here ties break by index in `before`).
__device__ __forceinline__ int rank_key(float x) {
  int b = isnan(x) ? 0x7f800000 : __float_as_int(x);
  if (b == (int)0x80000000) b = 0;
  return b < 0 ? b ^ 0x7FFFFFFF : b;
}

// 1 when element j (key kj) counts against element i (key ki): (kj, j) <
// (ki, i).  With j == i it counts only where i's two keys differ.  Keys are
// at most 0x7f800000 (+inf), so ki + 1 does not overflow: for j < i the
// test is kj <= ki.
__device__ __forceinline__ int before(int kj, int j, int ki, int i) {
  return kj < ki + (j < i);
}

// --- warp route: one warp a row, lane k owns equations k and k + 32 -----

// The later levels of a warp's halving tree, x[i] += x[i + m] for m = half
// / 2, ..., 1: the sum in lane 0.
template <class T>
__device__ __forceinline__ float warp_levels(float x, int half) {
  for (int m = half >> 1; m >= 1; m >>= 1)
    x = Ops<T>::add(x, __shfl_down_sync(FULL_MASK, x, m));
  return x;
}

// sum_p u[p] v[p] as the halving tree over 2 * half leaves (zero past P),
// its first level fma(u[i], v[i], u[i+half] v[i+half]) when `contract`, in
// lane i from its element i (ul, vl) and element i + half (uh, vh; `in`
// when i + half < P).  The sum in lane 0.
template <class T>
__device__ __forceinline__ float warp_dot(int half, bool contract, float ul, float vl,
                                          bool in, float uh, float vh) {
  using O = Ops<T>;
  if (half == 0) return O::mul(ul, vl);   // P == 1: one product
  const float hi = in ? O::mul(uh, vh) : 0.f;
  return warp_levels<T>(contract ? O::fma(ul, vl, hi) : O::add(O::mul(ul, vl), hi), half);
}

// sum_p x[p] as the halving tree (tree_sum_last): the sum in lane 0.
template <class T, int S>
__device__ __forceinline__ float warp_sum(int lane, int P, int half, const float (&x)[S]) {
  if (half == 0) return x[0];
  float xh;
  if constexpr (S == 2) xh = x[1];
  else xh = __shfl_down_sync(FULL_MASK, x[0], half);
  return warp_levels<T>(Ops<T>::add(x[0], lane + half < P ? xh : 0.f), half);
}

// rank[k] of the lane's element 32 k + lane: how many elements j count
// against it.  The warp's keys kJ go through its row of shared memory
// (INT_MAX past P, which counts against nothing) and every lane reads
// four at a time, the same address across the warp: a broadcast.
template <int S>
__device__ __forceinline__ void warp_ranks(int lane, int P, int* keys, const int (&kI)[S],
                                           const int (&kJ)[S], int (&rank)[S]) {
#pragma unroll
  for (int k = 0; k < S; ++k) {
    keys[32 * k + lane] = 32 * k + lane < P ? kJ[k] : 0x7fffffff;
    rank[k] = 0;
  }
  __syncwarp();
  const int4* k4 = reinterpret_cast<const int4*>(keys);
  const int n4 = (P + 3) >> 2;
#pragma unroll 4
  for (int j4 = 0; j4 < n4; ++j4) {
    const int4 q = k4[j4];
    const int j = 4 * j4;
#pragma unroll
    for (int k = 0; k < S; ++k) {
      const int i = 32 * k + lane;
      rank[k] += before(q.x, j, kI[k], i) + before(q.y, j + 1, kI[k], i) +
                 before(q.z, j + 2, kI[k], i) + before(q.w, j + 3, kI[k], i);
    }
  }
  __syncwarp();   // every lane has read the keys before the next pass writes them
}

// S = 1 for P <= 32, 2 for P <= 64.  Block: SWEEP_WARPS candidates of one
// window (blockIdx = window * groups + group).
template <class T, int S>
__global__ void __launch_bounds__(SWEEP_WARPS * 32)
sweep_warp_kernel(SweepArgs a) {
  using N = Num<T>;
  using O = Ops<T>;
  __shared__ float sx[2 * WARP_P], st[WARP_P], sl[WARP_P];
  __shared__ __align__(16) int skeys[SWEEP_WARPS][WARP_P];   // a row of keys a warp
  const int P = a.P, Q = a.Q;
  const int groups = (Q + SWEEP_WARPS - 1) / SWEEP_WARPS;
  const long long trow = blockIdx.x / groups;
  const int q = (int)(blockIdx.x % groups) * SWEEP_WARPS + (int)(threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  const T* X = (const T*)a.X;
  const T* tau = (const T*)a.tau + trow * P;
  for (int k = threadIdx.x; k < P; k += blockDim.x) {
    sx[2 * k] = N::ld(X[2 * k]);
    sx[2 * k + 1] = N::ld(X[2 * k + 1]);
    st[k] = N::ld(tau[k]);
    if (a.roles) sl[k] = a.lag[trow * P + k];
  }
  __syncthreads();
  if (q >= Q) return;   // the last group of a window; no barrier follows
  const long long row = trow * Q + q;
  float x0[S], x1[S], t[S], lg[S];
#pragma unroll
  for (int k = 0; k < S; ++k) {
    const int i = 32 * k + lane;
    const bool in = i < P;
    x0[k] = in ? sx[2 * i] : 0.f;
    x1[k] = in ? sx[2 * i + 1] : 0.f;
    t[k] = in ? st[i] : 0.f;
    lg[k] = in && a.roles ? sl[i] : 0.f;
  }
  const T* s_in = (const T*)a.s_in;
  float s0 = N::ld(s_in[2 * row]), s1 = N::ld(s_in[2 * row + 1]);
  const int half = P == 1 ? 0 : 1 << (31 - __clz(P - 1));
  // Element lane + half, the upper operand of lane's first tree level: the
  // lane's second element when half is 32, else lane + half's.
  const bool in_hi = lane + half < P;
  const float x0h = S == 2 ? x0[S - 1] : __shfl_down_sync(FULL_MASK, x0[0], half);
  const float x1h = S == 2 ? x1[S - 1] : __shfl_down_sync(FULL_MASK, x1[0], half);
  const float th = S == 2 ? t[S - 1] : __shfl_down_sync(FULL_MASK, t[0], half);
  int* keys = skeys[threadIdx.x >> 5];
  float r2[S], r2u[S], w[S];
  // One rank pass at the fit (s0, s1): the squared residuals, rounded and
  // (where a role of `need` asks) unrounded, the keys of roles bi (ranked)
  // and bj (counted against), w = rank < h (0 past P).
  auto pass = [&](int bi, int bj, int need) {
    int kI[S], kJ[S], rank[S];
#pragma unroll
    for (int k = 0; k < S; ++k) {
      const float xs = O::fma(x1[k], s1, O::mul(x0[k], s0));
      const float r = O::sub(t[k], xs);
      r2[k] = O::mul(r, r);
      r2u[k] = r2[k];
      if (a.roles & need) {
        const float ru = __fmaf_rn(lg[k], a.inv_fs, -xs);
        r2u[k] = __fmul_rn(ru, ru);
      }
      kI[k] = rank_key(a.roles & bi ? r2u[k] : r2[k]);
      kJ[k] = rank_key(a.roles & bj ? r2u[k] : r2[k]);
    }
    warp_ranks<S>(lane, P, keys, kI, kJ, rank);
#pragma unroll
    for (int k = 0; k < S; ++k) w[k] = 32 * k + lane < P && rank[k] < a.h ? 1.f : 0.f;
  };
  for (int step = 0; step < a.n_steps; ++step) {
    pass(ROLE_STEP_I, ROLE_STEP_J, ROLE_STEP_I | ROLE_STEP_J);
    // the leaves w X0, w X1, w tau of elements lane and lane + half
    const float wh = S == 2 ? w[S - 1] : __shfl_down_sync(FULL_MASK, w[0], half);
    const float wx0 = O::mul(w[0], x0[0]), wx1 = O::mul(w[0], x1[0]), wt = O::mul(w[0], t[0]);
    const float wx0h = O::mul(wh, x0h), wx1h = O::mul(wh, x1h), wth = O::mul(wh, th);
    const int c = a.contract;
    const float m00 = warp_dot<T>(half, c & 1, wx0, x0[0], in_hi, wx0h, x0h);
    const float m01 = warp_dot<T>(half, c & 2, wx0, x1[0], in_hi, wx0h, x1h);
    const float m11 = warp_dot<T>(half, c & 4, wx1, x1[0], in_hi, wx1h, x1h);
    const float b0 = warp_dot<T>(half, c & 8, wt, x0[0], in_hi, wth, x0h);
    const float b1 = warp_dot<T>(half, c & 16, wt, x1[0], in_hi, wth, x1h);
    const float2 sol = solve2<T>(m00, m01, m11, b0, b1, a.eps);   // right in lane 0
    s0 = __shfl_sync(FULL_MASK, sol.x, 0);
    s1 = __shfl_sync(FULL_MASK, sol.y, 0);
  }
  if (a.obj) {
    pass(ROLE_OBJ_I, ROLE_OBJ_J, ROLE_OBJ_I | ROLE_OBJ_J | ROLE_LO | ROLE_HI);
    float v[S];   // sel * r2, the leaves below half from lo, the others from hi
#pragma unroll
    for (int k = 0; k < S; ++k) {
      const int role = 32 * k + lane < half ? ROLE_LO : ROLE_HI;
      v[k] = O::mul(w[k], a.roles & role ? r2u[k] : r2[k]);
    }
    const float sum = warp_sum<T, S>(lane, P, half, v);
    if (lane == 0) ((T*)a.obj)[row] = N::st(isnan(sum) ? __int_as_float(0x7f800000) : sum);
  }
  if (lane == 0) {
    ((T*)a.s_out)[2 * row] = N::st(s0);
    ((T*)a.s_out)[2 * row + 1] = N::st(s1);
  }
}

// --- block route: one block a row (64 < P <= MAX_P), in shared memory ------

// The later levels of `n` halving trees in shared memory, x[i] += x[i + m]
// for m = half / 2, ..., 1: the sums in x[.][0].
template <class T, int N>
__device__ __forceinline__ void block_levels(float (&x)[5][MAX_HALF], int half) {
  for (int m = half >> 1; m >= 1; m >>= 1) {
    for (int i = threadIdx.x; i < m; i += blockDim.x) {
#pragma unroll
      for (int c = 0; c < N; ++c) x[c][i] = Ops<T>::add(x[c][i], x[c][i + m]);
    }
    __syncthreads();
  }
}

template <class T>
__global__ void __launch_bounds__(ROW_THREADS)
sweep_block_kernel(SweepArgs a) {
  using N = Num<T>;
  using O = Ops<T>;
  __shared__ float sx0[MAX_P], sx1[MAX_P], st[MAX_P], sl[MAX_P];
  __shared__ float sv[MAX_P];   // the objective's leaf residuals (role lo / hi)
  __shared__ float sw[MAX_P];   // weights, then the objective's sel * r2
  __shared__ int ski[MAX_P], skj[MAX_P];
  __shared__ float tree[5][MAX_HALF];
  __shared__ float ss[2];
  const int P = a.P, tid = threadIdx.x, nt = blockDim.x;
  const long long row = blockIdx.x, trow = row / a.Q;
  const T* X = (const T*)a.X;
  const T* tau = (const T*)a.tau + trow * P;
  for (int k = tid; k < P; k += nt) {
    sx0[k] = N::ld(X[2 * k]);
    sx1[k] = N::ld(X[2 * k + 1]);
    st[k] = N::ld(tau[k]);
    sl[k] = a.roles ? a.lag[trow * P + k] : 0.f;
  }
  if (tid == 0) {
    ss[0] = N::ld(((const T*)a.s_in)[2 * row]);
    ss[1] = N::ld(((const T*)a.s_in)[2 * row + 1]);
  }
  __syncthreads();
  const int half = 1 << (31 - __clz(P - 1));
  // One rank pass at the fit ss: keys of roles bi and bj, then sw = w or,
  // for the objective, w * r2.
  auto pass = [&](int bi, int bj, int need, bool objective) {
    const float s0 = ss[0], s1 = ss[1];
    for (int i = tid; i < P; i += nt) {
      const float xs = O::fma(sx1[i], s1, O::mul(sx0[i], s0));
      const float r = O::sub(st[i], xs);
      const float r2 = O::mul(r, r);
      float r2u = r2;
      if (a.roles & need) {
        const float ru = __fmaf_rn(sl[i], a.inv_fs, -xs);
        r2u = __fmul_rn(ru, ru);
      }
      ski[i] = rank_key(a.roles & bi ? r2u : r2);
      skj[i] = rank_key(a.roles & bj ? r2u : r2);
      sv[i] = a.roles & (i < half ? ROLE_LO : ROLE_HI) ? r2u : r2;
    }
    __syncthreads();
    for (int i = tid; i < P; i += nt) {
      const int ki = ski[i];
      int rank = 0;
      for (int j = 0; j < P; ++j) rank += before(skj[j], j, ki, i);
      const float w = rank < a.h ? 1.f : 0.f;
      sw[i] = objective ? O::mul(w, sv[i]) : w;
    }
    __syncthreads();
  };
  const int c = a.contract;
  for (int step = 0; step < a.n_steps; ++step) {
    pass(ROLE_STEP_I, ROLE_STEP_J, ROLE_STEP_I | ROLE_STEP_J, false);
    for (int i = tid; i < half; i += nt) {
      const int k = i + half;
      const bool in = k < P;
      const float wl = sw[i], x0l = sx0[i], x1l = sx1[i];
      const float wh = in ? sw[k] : 0.f, x0h = in ? sx0[k] : 0.f, x1h = in ? sx1[k] : 0.f;
      const float wx0l = O::mul(wl, x0l), wx1l = O::mul(wl, x1l), wtl = O::mul(wl, st[i]);
      const float wx0h = O::mul(wh, x0h), wx1h = O::mul(wh, x1h);
      const float wth = O::mul(wh, in ? st[k] : 0.f);
      auto first = [&](float ul, float vl, float uh, float vh, bool contract) {
        const float hi = in ? O::mul(uh, vh) : 0.f;
        return contract ? O::fma(ul, vl, hi) : O::add(O::mul(ul, vl), hi);
      };
      tree[0][i] = first(wx0l, x0l, wx0h, x0h, c & 1);
      tree[1][i] = first(wx0l, x1l, wx0h, x1h, c & 2);
      tree[2][i] = first(wx1l, x1l, wx1h, x1h, c & 4);
      tree[3][i] = first(wtl, x0l, wth, x0h, c & 8);
      tree[4][i] = first(wtl, x1l, wth, x1h, c & 16);
    }
    __syncthreads();
    block_levels<T, 5>(tree, half);
    if (tid == 0) {
      const float2 sol = solve2<T>(tree[0][0], tree[1][0], tree[2][0], tree[3][0],
                                   tree[4][0], a.eps);
      ss[0] = sol.x;
      ss[1] = sol.y;
    }
    __syncthreads();
  }
  if (a.obj) {
    pass(ROLE_OBJ_I, ROLE_OBJ_J, ROLE_OBJ_I | ROLE_OBJ_J | ROLE_LO | ROLE_HI, true);
    for (int i = tid; i < half; i += nt)
      tree[0][i] = O::add(sw[i], i + half < P ? sw[i + half] : 0.f);
    __syncthreads();
    block_levels<T, 1>(tree, half);
    if (tid == 0) {
      const float sum = tree[0][0];
      ((T*)a.obj)[row] = N::st(isnan(sum) ? __int_as_float(0x7f800000) : sum);
    }
  }
  if (tid == 0) {
    ((T*)a.s_out)[2 * row] = N::st(ss[0]);
    ((T*)a.s_out)[2 * row + 1] = N::st(ss[1]);
  }
}

// --- thread route: one thread a row, P fixed at compile time ---------------

// Half the next power of two of P (0 for P == 1): the first level's width
// of the halving trees over P leaves.
__host__ __device__ constexpr int tree_half(int P) {
  int h = 1;
  while (2 * h < P) h *= 2;
  return P == 1 ? 0 : h;
}

// Block: ROW_BLOCK candidates of one window (blockIdx = window * groups +
// group).  se[k] holds equation k's (X0, X1, tau, lag); skj[k][thread] the
// counted-against key of equation k where a pass's keys differ.
template <class T, int P>
__global__ void __launch_bounds__(ROW_BLOCK)
sweep_thread_kernel(SweepArgs a) {
  using N = Num<T>;
  using O = Ops<T>;
  constexpr int H = tree_half(P);
  static_assert(H >= 2 && H <= REG_HALF && P <= 64, "thread route: 3 <= P <= 64");
  __shared__ float4 se[P];
  __shared__ int skj[P][ROW_BLOCK];
  const int Q = a.Q;
  const int groups = (Q + ROW_BLOCK - 1) / ROW_BLOCK;
  const long long trow = blockIdx.x / groups;
  const int q = (int)(blockIdx.x % groups) * ROW_BLOCK + (int)threadIdx.x;
  const T* X = (const T*)a.X;
  const T* tau = (const T*)a.tau + trow * P;
  for (int k = threadIdx.x; k < P; k += ROW_BLOCK)
    se[k] = make_float4(N::ld(X[2 * k]), N::ld(X[2 * k + 1]), N::ld(tau[k]),
                        a.roles ? a.lag[trow * P + k] : 0.f);
  __syncthreads();
  if (q >= Q) return;   // the last group of a window; no barrier follows
  const long long row = trow * Q + q;
  const T* s_in = (const T*)a.s_in;
  float s0 = N::ld(s_in[2 * row]), s1 = N::ld(s_in[2 * row + 1]);
  // Equation k's squared residual at (s0, s1), rounded, and (where `un`)
  // from the unrounded delay lag * inv_fs.
  auto residual = [&](int k, bool un, float& r2, float& r2u) {
    const float4 e = se[k];
    const float xs = O::fma(e.y, s1, O::mul(e.x, s0));
    const float r = O::sub(e.z, xs);
    r2 = O::mul(r, r);
    r2u = r2;
    if (un) {
      const float ru = __fmaf_rn(e.w, a.inv_fs, -xs);
      r2u = __fmul_rn(ru, ru);
    }
  };
  // The staged rows are read from shared memory (a broadcast) in each
  // pass and each refit: `reload` (a memory clobber) keeps the compiler
  // from holding them in registers across the ranks, which would cost 4 P
  // registers a thread and with them occupancy.
  auto reload = [] { asm volatile("" ::: "memory"); };
  // One rank pass at (s0, s1): the keys of roles bi (ranked) and bj
  // (counted against); bit k of the result is w_k = rank_k < h.
  auto pass = [&](int bi, int bj, int need) {
    reload();
    const bool un = a.roles & need, ui = a.roles & bi, uj = a.roles & bj;
    // A key as a float: the value, NaN as +inf.  Float `<` orders these
    // as rank_key's integers do (-0 equal to +0, NaN last).
    float key[P];
#pragma unroll
    for (int k = 0; k < P; ++k) {
      float r2, r2u;
      residual(k, un, r2, r2u);
      const float x = ui ? r2u : r2;
      key[k] = isnan(x) ? __int_as_float(0x7f800000) : x;
      if (ui != uj) skj[k][threadIdx.x] = rank_key(uj ? r2u : r2);
    }
    unsigned long long w = 0;
    if (ui == uj) {   // one comparison a pair; counts as floats, exact
      float rank[P];
#pragma unroll
      for (int k = 0; k < P; ++k) rank[k] = (float)k;
#pragma unroll
      for (int j = 1; j < P; ++j) {
#pragma unroll
        for (int i = 0; i < j; ++i) {
          const float c = key[j] < key[i] ? 1.f : 0.f;
          rank[i] += c;
          rank[j] -= c;
        }
      }
      const float h = (float)a.h;
#pragma unroll
      for (int k = 0; k < P; ++k) w |= (unsigned long long)(rank[k] < h) << k;
    } else {          // every ordered pair, the diagonal included
      int rank[P];
#pragma unroll
      for (int k = 0; k < P; ++k) rank[k] = 0;
#pragma unroll 2
      for (int j = 0; j < P; ++j) {
        const int kj = skj[j][threadIdx.x];
#pragma unroll
        for (int i = 0; i < P; ++i) rank[i] += before(kj, j, rank_key(key[i]), i);
      }
#pragma unroll
      for (int k = 0; k < P; ++k) w |= (unsigned long long)(rank[k] < a.h) << k;
    }
    return w;
  };
  const int c = a.contract;
#pragma unroll 1
  for (int step = 0; step < a.n_steps; ++step) {
    const unsigned long long m = pass(ROLE_STEP_I, ROLE_STEP_J, ROLE_STEP_I | ROLE_STEP_J);
    // The five trees' first levels in one sweep of the rows: leaves (u, v)
    // of sum t, w X0 . X0, w X0 . X1, w X1 . X1, w tau . X0, w tau . X1;
    // x[t][i] = fma(u_i, v_i, u_{i+H} v_{i+H}) where bit t of `contract`
    // is set, else u_i v_i + u_{i+H} v_{i+H}, the upper term 0 past P
    // (first_level's arithmetic).
    reload();
    float x[5][H];
#pragma unroll
    for (int i = 0; i < H; ++i) {
      const float4 e = se[i];
      const float wi = (m >> i) & 1 ? 1.f : 0.f;
      const float wx0 = O::mul(wi, e.x), wx1 = O::mul(wi, e.y), wt = O::mul(wi, e.z);
      const float u[5] = {wx0, wx0, wx1, wt, wt}, v[5] = {e.x, e.y, e.y, e.x, e.y};
      float hi[5] = {0.f, 0.f, 0.f, 0.f, 0.f};
      if (i + H < P) {
        const float4 f = se[i + H];
        const float wh = (m >> (i + H)) & 1 ? 1.f : 0.f;
        const float hx0 = O::mul(wh, f.x), hx1 = O::mul(wh, f.y), ht = O::mul(wh, f.z);
        hi[0] = O::mul(hx0, f.x);
        hi[1] = O::mul(hx0, f.y);
        hi[2] = O::mul(hx1, f.y);
        hi[3] = O::mul(ht, f.x);
        hi[4] = O::mul(ht, f.y);
      }
#pragma unroll
      for (int t = 0; t < 5; ++t)
        x[t][i] = (c >> t) & 1 ? O::fma(u[t], v[t], hi[t]) : O::add(O::mul(u[t], v[t]), hi[t]);
    }
#pragma unroll
    for (int t = 0; t < 5; ++t) reduce_levels<T, H / 2>(x[t]);
    const float2 sol = solve2<T>(x[0][0], x[1][0], x[2][0], x[3][0], x[4][0], a.eps);
    s0 = sol.x;
    s1 = sol.y;
  }
  if (a.obj) {
    constexpr int need = ROLE_OBJ_I | ROLE_OBJ_J | ROLE_LO | ROLE_HI;
    const unsigned long long m = pass(ROLE_OBJ_I, ROLE_OBJ_J, need);
    const bool un = a.roles & need;
    reload();
    // sel * r2, the leaves below H from role lo's residuals, the others
    // from hi's; the residuals again, bit for bit the pass's
    auto v = [&](int k) {
      float r2, r2u;
      residual(k, un, r2, r2u);
      const int role = k < H ? ROLE_LO : ROLE_HI;
      return O::mul((m >> k) & 1 ? 1.f : 0.f, a.roles & role ? r2u : r2);
    };
    float x[H];
#pragma unroll
    for (int i = 0; i < H; ++i) x[i] = O::add(v(i), i + H < P ? v(i + H) : 0.f);
    reduce_levels<T, H / 2>(x);
    ((T*)a.obj)[row] = N::st(isnan(x[0]) ? __int_as_float(0x7f800000) : x[0]);
  }
  ((T*)a.s_out)[2 * row] = N::st(s0);
  ((T*)a.s_out)[2 * row + 1] = N::st(s1);
}

// ---------------------------------------------------------------------------
// nbls_lts_final: the final subset, one warp a window
// ---------------------------------------------------------------------------

constexpr int FINAL_WARPS = 4;   // windows a block
// Which of the final subset's squared residuals take the unrounded delay
// lag * inv_fs (ops/kernels/lts_sweep.py::FINAL_ROLES): the ranks of the
// retained subset (the one-band programs' "final.i" and "final.j", always
// together) and sigma_tau's.
constexpr int FINAL_RANKS = 1, FINAL_SIGMA2 = 2;
// The constants of the ellipse, each the float32 of the double that PyTorch
// casts a Python scalar from: smag2's floor, the determinant's threshold and
// torch.rad2deg's factor (ATen's M_180_PI).
constexpr float SMAG2_MIN = static_cast<float>(1e-30);
constexpr float DET_EPS = static_cast<float>(1e-12);
constexpr float RAD2DEG = static_cast<float>(57.295779513082320876798154814105170332405472466564);

struct FinalArgs {
  const void* tau;       // (rows, P)
  const void* X;         // (P, 2)
  const void* obj;       // (rows, K)
  const void* s;         // (rows, K, 2)
  const float* lag;      // (rows, P) or null when roles == 0
  float inv_fs;
  void* obj_out;         // (rows): the first minimum's objective
  void* s_out;           // (rows, 2): the refit of the retained subset
  unsigned char* retained;   // (rows, P), 0 or 1
  void* sig_tau;         // (rows)
  void* vel_uncert;      // (rows)
  void* baz_uncert;      // (rows)
  long long rows;
  int K, P, h, contract, roles;
  float dof, eps;
};

// (va, ia) comes before (vb, ib) in torch.argmin's order: NaN first (the
// minimum, as argmin propagates it), then the smaller value, equal values
// (-0 == +0) and NaNs by index.
__device__ __forceinline__ bool first_min_before(float va, int ia, float vb, int ib) {
  const bool na = isnan(va), nb = isnan(vb);
  if (na != nb) return na;
  if (na || va == vb) return ia < ib;
  return va < vb;
}

// torch.clamp(x, min=lo): NaN stays NaN (fmaxf would drop it).
__device__ __forceinline__ float clamp_min(float x, float lo) { return x < lo ? lo : x; }

// S = 1 for P <= 32, 2 for P <= 64.  Block: FINAL_WARPS windows, one a warp;
// lane k owns equations k and k + 32.
template <class T, int S>
__global__ void __launch_bounds__(FINAL_WARPS * 32)
final_kernel(FinalArgs a) {
  using N = Num<T>;
  using O = Ops<T>;
  __shared__ __align__(16) int skeys[FINAL_WARPS][WARP_P];   // a row of keys a warp
  const long long row = blockIdx.x * (long long)FINAL_WARPS + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= a.rows) return;   // whole warps; no block barrier follows
  const int P = a.P, K = a.K;

  // The first minimum of the row's objectives: each lane strides over K
  // (neighbouring lanes on neighbouring addresses) keeping its first
  // minimum, then the lanes merge, the lower index winning a tie.  (+inf,
  // K) stands for "none": any objective comes before it.
  const T* obj = (const T*)a.obj + row * K;
  float best = __int_as_float(0x7f800000);
  int bi = K;
  for (int k = lane; k < K; k += 32) {
    const float v = N::ld(obj[k]);
    if (first_min_before(v, k, best, bi)) {
      best = v;
      bi = k;
    }
  }
#pragma unroll
  for (int m = 16; m >= 1; m >>= 1) {
    const float v = __shfl_down_sync(FULL_MASK, best, m);
    const int i = __shfl_down_sync(FULL_MASK, bi, m);
    if (first_min_before(v, i, best, bi)) {
      best = v;
      bi = i;
    }
  }
  bi = __shfl_sync(FULL_MASK, bi, 0);
  const T* sb = (const T*)a.s + (row * K + bi) * 2;
  float s0 = N::ld(sb[0]), s1 = N::ld(sb[1]);

  float x0[S], x1[S], t[S], lg[S];
#pragma unroll
  for (int k = 0; k < S; ++k) {
    const int i = 32 * k + lane;
    const bool in = i < P;
    x0[k] = in ? N::ld(((const T*)a.X)[2 * i]) : 0.f;
    x1[k] = in ? N::ld(((const T*)a.X)[2 * i + 1]) : 0.f;
    t[k] = in ? N::ld(((const T*)a.tau)[row * P + i]) : 0.f;
    lg[k] = in && a.roles ? a.lag[row * P + i] : 0.f;
  }
  const int half = P == 1 ? 0 : 1 << (31 - __clz(P - 1));
  // Element lane + half, the upper operand of lane's first tree level: the
  // lane's second element when half is 32, else lane + half's.
  const bool in_hi = lane + half < P;
  const float x0h = S == 2 ? x0[S - 1] : __shfl_down_sync(FULL_MASK, x0[0], half);
  const float x1h = S == 2 ? x1[S - 1] : __shfl_down_sync(FULL_MASK, x1[0], half);
  const float th = S == 2 ? t[S - 1] : __shfl_down_sync(FULL_MASK, t[0], half);
  // Equation k's squared residual at (s0, s1), from the rounded delay or,
  // where `un`, from the unrounded lag * inv_fs.
  auto residual2 = [&](int k, bool un) {
    const float xs = O::fma(x1[k], s1, O::mul(x0[k], s0));
    if (un) {
      const float ru = __fmaf_rn(lg[k], a.inv_fs, -xs);
      return __fmul_rn(ru, ru);
    }
    const float r = O::sub(t[k], xs);
    return O::mul(r, r);
  };

  // The retained subset: rank < h, ranks by (key, index) as rank_along_last.
  int key[S], rank[S];
#pragma unroll
  for (int k = 0; k < S; ++k) key[k] = rank_key(residual2(k, a.roles & FINAL_RANKS));
  warp_ranks<S>(lane, P, skeys[threadIdx.x >> 5], key, key, rank);
  float w[S];
#pragma unroll
  for (int k = 0; k < S; ++k) {
    const int i = 32 * k + lane;
    const bool keep = i < P && rank[k] < a.h;
    w[k] = keep ? 1.f : 0.f;
    if (i < P) a.retained[row * P + i] = keep;
  }

  // The refit of the retained subset, as sweep_warp_kernel's C-step.
  const float wh = S == 2 ? w[S - 1] : __shfl_down_sync(FULL_MASK, w[0], half);
  const float wx0 = O::mul(w[0], x0[0]), wx1 = O::mul(w[0], x1[0]), wt = O::mul(w[0], t[0]);
  const float wx0h = O::mul(wh, x0h), wx1h = O::mul(wh, x1h), wth = O::mul(wh, th);
  const int c = a.contract;
  const float r00 = warp_dot<T>(half, c & 1, wx0, x0[0], in_hi, wx0h, x0h);
  const float r01 = warp_dot<T>(half, c & 2, wx0, x1[0], in_hi, wx0h, x1h);
  const float r11 = warp_dot<T>(half, c & 4, wx1, x1[0], in_hi, wx1h, x1h);
  const float b0 = warp_dot<T>(half, c & 8, wt, x0[0], in_hi, wth, x0h);
  const float b1 = warp_dot<T>(half, c & 16, wt, x1[0], in_hi, wth, x1h);
  const float2 sol = solve2<T>(r00, r01, r11, b0, b1, a.eps);   // right in lane 0
  s0 = __shfl_sync(FULL_MASK, sol.x, 0);
  s1 = __shfl_sync(FULL_MASK, sol.y, 0);

  // sigma_tau's sum of w r2 and the ellipse's sums of (w X_a) X_b, each the
  // halving tree of tree_sum_last.
  float v[S], e00[S], e01[S], e11[S];
#pragma unroll
  for (int k = 0; k < S; ++k) {
    v[k] = O::mul(w[k], residual2(k, a.roles & FINAL_SIGMA2));
    const float u0 = O::mul(w[k], x0[k]), u1 = O::mul(w[k], x1[k]);
    e00[k] = O::mul(u0, x0[k]);
    e01[k] = O::mul(u0, x1[k]);
    e11[k] = O::mul(u1, x1[k]);
  }
  const float sum = warp_sum<T, S>(lane, P, half, v);
  const float m00 = warp_sum<T, S>(lane, P, half, e00);
  const float m01 = warp_sum<T, S>(lane, P, half, e01);
  const float m11 = warp_sum<T, S>(lane, P, half, e11);
  if (lane != 0) return;

  // The ellipse in the order ops/kernels/lts_sweep.py::final_reference
  // writes it, each operation rounded on its own.
  const float sigma2 = O::div(sum, a.dof);
  const float det = O::sub(O::mul(m00, m11), O::mul(m01, m01));
  const float safe = fabsf(det) > DET_EPS ? det : 1.f;
  const float i00 = O::div(m11, safe), i01 = O::div(-m01, safe), i11 = O::div(m00, safe);
  const float sx = s0, sy = s1;
  const float smag2 = N::rn(clamp_min(O::add(O::mul(sx, sx), O::mul(sy, sy)), SMAG2_MIN));
  const float smag = O::sqrt(smag2);
  const float gvx = O::div(-sx, O::mul(smag2, smag)), gvy = O::div(-sy, O::mul(smag2, smag));
  // sigma2 (i00 gx gx + 2 i01 gx gy + i11 gy gy), left to right
  auto quad = [&](float gx, float gy) {
    const float q = O::add(O::mul(O::mul(i00, gx), gx), O::mul(O::mul(O::mul(2.f, i01), gx), gy));
    return O::mul(sigma2, O::add(q, O::mul(O::mul(i11, gy), gy)));
  };
  const float var_v = quad(gvx, gvy);
  const float var_t = quad(O::div(-sy, smag2), O::div(sx, smag2));
  ((T*)a.obj_out)[row] = obj[bi];
  ((T*)a.s_out)[2 * row] = N::st(s0);
  ((T*)a.s_out)[2 * row + 1] = N::st(s1);
  ((T*)a.sig_tau)[row] = N::st(O::sqrt(sigma2));
  ((T*)a.vel_uncert)[row] = N::st(O::sqrt(clamp_min(var_v, 0.f)));
  ((T*)a.baz_uncert)[row] = N::st(O::mul(O::sqrt(clamp_min(var_t, 0.f)), RAD2DEG));
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

constexpr long long kMaxGrid = 0x7fffffffLL;

template <class T, int P>
int sweep_thread(const SweepArgs& a, int* launched, cudaStream_t stream) {
  const long long blocks = a.rows_tau * ((a.Q + ROW_BLOCK - 1) / ROW_BLOCK);
  if (blocks > kMaxGrid) return (int)cudaErrorInvalidValue;
  sweep_thread_kernel<T, P><<<(unsigned)blocks, ROW_BLOCK, 0, stream>>>(a);
  *launched = LAUNCHED_THREAD;
  return (int)cudaGetLastError();
}

// The route by P: the thread route at its sizes (float32), the warp route
// at any other P <= WARP_P, the block route above; the route taken goes to
// *launched.  Timed against the warp route at each of its sizes, in each
// launch an LTS solve makes (chip_smoke.py::sweep_route_sizes), the thread
// route wins all but a capped sweep of 5 candidates at P = 28 and 36, which
// is opt-in and small beside the solves it wins (PERF.md, section 6).  ops/kernels/lts_sweep.py::sweep_route mirrors this choice,
// and the wrapper holds each launch's route to it.
template <class T>
int sweep(const SweepArgs& a, int route, int* launched, cudaStream_t stream) {
  if constexpr (std::is_same<T, float>::value) {
    if (route == ROUTE_BY_P) {
      switch (a.P) {
        case 3: return sweep_thread<T, 3>(a, launched, stream);
        case 6: return sweep_thread<T, 6>(a, launched, stream);
        case 10: return sweep_thread<T, 10>(a, launched, stream);
        case 15: return sweep_thread<T, 15>(a, launched, stream);
        case 21: return sweep_thread<T, 21>(a, launched, stream);
        case 28: return sweep_thread<T, 28>(a, launched, stream);
        case 36: return sweep_thread<T, 36>(a, launched, stream);
      }
    }
  }
  if (a.P <= WARP_P) {
    const long long blocks = a.rows_tau * ((a.Q + SWEEP_WARPS - 1) / SWEEP_WARPS);
    if (blocks > kMaxGrid) return (int)cudaErrorInvalidValue;
    if (a.P <= 32)
      sweep_warp_kernel<T, 1><<<(unsigned)blocks, SWEEP_WARPS * 32, 0, stream>>>(a);
    else
      sweep_warp_kernel<T, 2><<<(unsigned)blocks, SWEEP_WARPS * 32, 0, stream>>>(a);
    *launched = LAUNCHED_WARP;
  } else {
    const long long blocks = a.rows_tau * a.Q;
    if (blocks > kMaxGrid) return (int)cudaErrorInvalidValue;
    sweep_block_kernel<T><<<(unsigned)blocks, ROW_THREADS, 0, stream>>>(a);
    *launched = LAUNCHED_BLOCK;
  }
  return (int)cudaGetLastError();
}

template <class T>
int final_launch(const FinalArgs& a, int* launched, cudaStream_t stream) {
  const long long blocks = (a.rows + FINAL_WARPS - 1) / FINAL_WARPS;
  if (blocks > kMaxGrid) return (int)cudaErrorInvalidValue;
  if (a.P <= 32)
    final_kernel<T, 1><<<(unsigned)blocks, FINAL_WARPS * 32, 0, stream>>>(a);
  else
    final_kernel<T, 2><<<(unsigned)blocks, FINAL_WARPS * 32, 0, stream>>>(a);
  *launched = LAUNCHED_WARP;
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

// The candidate sweep of s_in (rows_tau, Q, 2) on tau (rows_tau, P) through
// X (P, 2): n_steps C-steps (weights rank < h, the refit's first levels
// contracted per `contract`), then, when `objective`, the trimmed objective
// into obj (rows_tau, Q); the final fits into s_out (rows_tau, Q, 2).  Bit
// k of `roles` (ROLE_*) takes that role's squared residuals from the
// unrounded delay lag * inv_fs (lag (rows_tau, P), float32 only).  P <=
// MAX_P; dtype code 0/1/2.  `route` is ROUTE_BY_P, or ROUTE_NO_THREAD to
// time the warp route where the thread route would run; the route launched
// (LAUNCHED_*) goes to *launched.
int nbls_lts_sweep(int dtype, const void* tau, const void* X, const void* s_in,
                   const float* lag, float inv_fs, void* s_out, void* obj,
                   long long rows_tau, int Q, int P, int h, int n_steps, int contract,
                   int objective, int roles, float eps, int route, int* launched,
                   cudaStream_t stream) {
  if (rows_tau <= 0 || Q <= 0 || P <= 0 || P > MAX_P || n_steps < 0 ||
      (route != ROUTE_BY_P && route != ROUTE_NO_THREAD) || launched == nullptr)
    return (int)cudaErrorInvalidValue;
  if ((roles && (dtype != 0 || lag == nullptr)) || (objective && obj == nullptr))
    return (int)cudaErrorInvalidValue;
  const SweepArgs a{tau,   X, s_in, roles ? lag : nullptr, inv_fs, s_out,
                    objective ? obj : nullptr, rows_tau, Q, P, h, n_steps, contract,
                    roles, eps};
  switch (dtype) {
    case 0: return sweep<float>(a, route, launched, stream);
    case 1: return sweep<__nv_bfloat16>(a, route, launched, stream);
    case 2: return sweep<__half>(a, route, launched, stream);
  }
  return (int)cudaErrorInvalidValue;
}

// The final subset of rows windows: the first minimum of obj (rows, K)
// and its fit of s (rows, K, 2), the ranks of that fit's squared residuals
// on tau (rows, P) through X (P, 2), retained = rank < h into retained
// (rows, P; bytes 0/1), the refit of the retained subset (contract as
// nbls_lts_refit's, eps) into s_out (rows, 2), the first minimum into
// obj_out (rows), sigma_tau (the tree sum of the retained squared
// residuals of s_out over dof) and the two uncertainties into sig_tau,
// vel_uncert, baz_uncert (rows).  Bit FINAL_RANKS / FINAL_SIGMA2 of `roles`
// takes the ranks' / sigma_tau's residuals from the unrounded delay lag
// (rows, P) * inv_fs (float32 only).  P <= WARP_P; dtype code 0/1/2.  The
// route launched (LAUNCHED_WARP, one warp a window) goes to *launched.
int nbls_lts_final(int dtype, const void* tau, const void* X, const void* obj, const void* s,
                   const float* lag, float inv_fs, void* obj_out, void* s_out,
                   void* retained, void* sig_tau, void* vel_uncert, void* baz_uncert,
                   long long rows, int K, int P, int h, int dof, int contract, int roles,
                   float eps, int* launched, cudaStream_t stream) {
  if (rows <= 0 || K <= 0 || P <= 0 || P > WARP_P || dof <= 0 || launched == nullptr)
    return (int)cudaErrorInvalidValue;
  if (roles && (dtype != 0 || lag == nullptr)) return (int)cudaErrorInvalidValue;
  const FinalArgs a{tau,     X,         obj,        s,          roles ? lag : nullptr,
                    inv_fs,  obj_out,   s_out,      (unsigned char*)retained,
                    sig_tau, vel_uncert, baz_uncert, rows, K, P, h, contract, roles,
                    (float)dof, eps};
  switch (dtype) {
    case 0: return final_launch<float>(a, launched, stream);
    case 1: return final_launch<__nv_bfloat16>(a, launched, stream);
    case 2: return final_launch<__half>(a, launched, stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
