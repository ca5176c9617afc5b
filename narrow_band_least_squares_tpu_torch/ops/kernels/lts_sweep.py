"""The LTS sweep's arithmetic with the JAX package's contractions,
``csrc/lts_sweep.cu``.

The port's own kernels, not the counterpart of a TPU kernel: the JAX
package's sweep (``narrow_band_least_squares_tpu/ops/lts.py``) is plain
XLA, and XLA's CPU backend contracts a multiply whose product feeds an add
inside one fusion into a fused multiply-add (one rounding).  The flags
hang on the last bits of the squared residuals, so the port computes the
same roundings, in six entry points:

- `sweep` (the candidate sweep, ``ops.lts._candidate_sweep``): for each
  (window, candidate) row, ``n_steps`` C-steps (the residuals, their rank
  keys, ranks by comparison, weights ``rank < h`` and the refit below),
  then, when asked, the trimmed objective (the tree of `tree_sum_last`
  over ``sel * r2``, NaN -> inf), in one launch; its plain version,
  `sweep_reference`, composes the plain versions of the passes below and
  `rank_along_last`, as the sweep did before it had a kernel;
- `residuals2` (``_residuals2`` and the final subset's separate passes):
  ``r = tau - fma(X[p,1], s1, X[p,0] * s0)``, ``r2 = r * r``;
- `residuals2_lag` (the sites where the one-band programs fuse the delays'
  product into the residual, `ops.lts.delay_contracted`; float32 only):
  ``r = fma(lag, inv_fs, -fma(X[p,1], s1, X[p,0] * s0))``, the delay ``lag
  * inv_fs`` unrounded, ``r2 = r * r``;
- `refit` (``masked_refit``): five halving trees over the next power of
  two, zero-padded (``u = w X0, v = X0`` for m00; ``w X0, X1`` for m01;
  ``w X1, X1`` for m11; ``w tau, X0`` and ``w tau, X1`` for b0 and b1),
  whose first level is ``fma(u[i], v[i], u[i+h] * v[i+h])`` for the sums
  whose bit is set in ``contract`` (`SUMS` order) and ``u[i] * v[i] +
  u[i+h] * v[i+h]`` for the others, and whose later levels are plain adds;
  then ``det = fma(m00, m11, -(m01 m01))``, the
  numerators ``fma(b0, m11, -(b1 m01))`` and ``fma(b1, m00, -(b0 m01))``,
  one division each and zeros where ``|det| <= eps``;
- `elemental` (the candidates' 2x2 solves): ``s_i = fma(Ainv[q,i,1], t1,
  Ainv[q,i,0] * t0)`` with ``t = tau[cand[q]]``;
- `final` (the final subset of a solve, ``ops.lts.lts_solve``): the first
  minimum of the candidates' objectives, the ranks of its fit's residuals,
  the refit of the h smallest, sigma_tau and the uncertainty ellipse, one
  launch a solve; its plain version, `final_reference`, composes the plain
  versions of the passes above with eager arithmetic and fixed-tree sums.

Every other multiply, add and division is rounded on its own.  In a dtype
narrower than float32 nothing is contracted: each operation is taken in
float32 and rounded to the dtype, as PyTorch does (the JAX package's
narrow dtypes round where XLA's fusions end, which the port matches only
within their rounding, ``tests/test_torch_dtypes.py``).

A CUDA tensor goes to the kernel of its entry point, which counts a launch
in ``launches_sweep``, ``launches_residuals2``, ``launches_residuals2_lag``,
``launches_refit``, ``launches_elemental`` or ``launches_final``; `sweep`
has three routes, chosen by P alone (`sweep_route`), and also counts the
launches that the launcher reports on its thread route in
``launches_sweep_thread``; `final` takes rows of at most `WARP_P`
equations (`final_route`); a
CPU tensor goes to its plain version (``*_reference``), which the kernels
equal bit for bit.  The plain versions build on `fma`, an exact float32
fused multiply-add: the float32 product is exact in float64, and the
float64 sum is rounded to odd (Boldo and Melquiond) before it is rounded to
float32, so the one float32 rounding is that of the exact result.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch
import torch.nn.functional as Fnn

# Launches of each kernel since its count was last set to 0.
launches_sweep = 0
launches_sweep_thread = 0     # of launches_sweep, those the launcher reports on
                              # its thread route
launches_residuals2 = 0
launches_residuals2_lag = 0
launches_refit = 0
launches_elemental = 0
launches_final = 0

# Longest row `refit` takes on the card (P delay equations, 45 elements).
MAX_P = 1024
# The refit's five sums, in the bit order of ``contract``; every first
# level contracted:
SUMS = ("m00", "m01", "m11", "b0", "b1")
ALL_CONTRACTED = (1 << len(SUMS)) - 1
# The squared residuals of `sweep` that may take the unrounded delay ``lag *
# inv_fs`` (``ops.lts.delay_contracted``'s roles), in the bit order of
# ``roles``: the C-steps' ranked keys and the keys they are counted against,
# the objective's, and the halves of the objective tree's first level.
ROLES = ("step.i", "step.j", "objective.i", "objective.j", "objective.lo", "objective.hi")
# `sweep`'s routes by P (csrc/lts_sweep.cu): one thread a row at these
# sizes (the co-arrays of 3 to 9 elements; float32), one warp a row at any
# other P <= WARP_P, one block a row above
THREAD_SIZES = (3, 6, 10, 15, 21, 28, 36)
WARP_P = 64
# the routes by the code nbls_lts_sweep and nbls_lts_final report for the
# one they launched
ROUTES = ("thread", "warp", "block")
# The final subset's squared residuals that may take the unrounded delay
# (``ops.lts.delay_contracted``'s sites), in the bit order of `final`'s
# ``roles``: the ranks of the retained subset ("final.i" and "final.j",
# always together) and sigma_tau's ("sigma2").
FINAL_ROLES = ("final", "sigma2")
# The constants of the uncertainty ellipse: the floor of |s|^2 and the
# threshold of the retained subset's normal determinant.
SMAG2_MIN, DET_EPS = 1e-30, 1e-12
# dtype codes of the C interface
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# Byte budget of the (rows, P, P) boolean temporary of one `rank_along_last`
# chunk: the canonical plan's sweep (632 windows x 378 candidates, P = 28)
# takes one chunk, a 50-band plan two.
RANK_CHUNK_BYTES = 1 << 30

_bound = None


def _lib():
    global _bound
    if _bound is None:
        from narrow_band_least_squares_tpu_torch.ops.kernels._build import load_library

        lib = load_library("lts_sweep")
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.nbls_lts_residuals2.argtypes = [i, p, p, p, p, ll, i, i, p]
        lib.nbls_lts_residuals2_lag.argtypes = [p, ctypes.c_float, p, p, p, ll, i, i, p]
        lib.nbls_lts_refit.argtypes = [i, p, p, p, p, ll, i, i, ctypes.c_float, i, p]
        lib.nbls_lts_elemental.argtypes = [i, p, p, p, p, ll, i, i, p]
        lib.nbls_lts_sweep.argtypes = [i, p, p, p, p, ctypes.c_float, p, p, ll,
                                       i, i, i, i, i, i, i, ctypes.c_float, i,
                                       ctypes.POINTER(ctypes.c_int), p]
        lib.nbls_lts_final.argtypes = [i, p, p, p, p, p, ctypes.c_float, p, p, p, p, p, p,
                                       ll, i, i, i, i, i, i, ctypes.c_float,
                                       ctypes.POINTER(ctypes.c_int), p]
        for fn in (lib.nbls_lts_residuals2, lib.nbls_lts_residuals2_lag, lib.nbls_lts_refit,
                   lib.nbls_lts_elemental, lib.nbls_lts_sweep, lib.nbls_lts_final):
            fn.restype = ctypes.c_int
        _bound = lib
    return _bound


# --------------------------------------------------------------------------
# plain versions
# --------------------------------------------------------------------------

def fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` of float32 tensors rounded once (IEEE ``fmaf``),
    broadcast; in a narrower dtype the multiply and the add, each rounded
    to the dtype."""
    if a.dtype != torch.float32:
        return a * b + c
    a, b, c = (t.double() for t in torch.broadcast_tensors(a, b, c))
    p = a * b                                  # exact: 24 + 24 bits
    s = p + c
    bp = s - p                                 # TwoSum: s + e == p + c exactly
    e = (p - (s - bp)) + (c - bp)
    odd = (s.view(torch.int64) & 1) == 1
    inexact = (e != 0) & ~odd & torch.isfinite(s)
    inf = torch.full_like(s, float("inf"))
    s = torch.where(inexact, torch.nextafter(s, torch.where(e > 0, inf, -inf)), s)
    return s.float()


def residuals2_reference(tau: torch.Tensor, X: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Squared residuals (..., Q, P) of the fits s (..., Q, 2) to tau (..., P)."""
    xs = fma(X[:, 1], s[..., 1, None], X[:, 0] * s[..., 0, None])
    r = tau[..., None, :] - xs
    return r * r


def residuals2_lag_reference(lag: torch.Tensor, inv_fs: float, X: torch.Tensor,
                             s: torch.Tensor) -> torch.Tensor:
    """Squared residuals (..., Q, P) of the fits s (..., Q, 2) to the delays
    ``lag * inv_fs`` (lag (..., P), float32), each ``fma(lag, inv_fs,
    -xs)``: the delay's product unrounded."""
    xs = fma(X[:, 1], s[..., 1, None], X[:, 0] * s[..., 0, None])
    inv = torch.tensor(inv_fs, dtype=torch.float32, device=lag.device)
    r = fma(lag[..., None, :], inv, -xs)
    return r * r


def _tree_dot(u: torch.Tensor, v: torch.Tensor, contract: bool) -> torch.Tensor:
    """sum_p u v over the last axis as a halving tree over the next power of
    two, zero-padded, its first level contracted or not."""
    n = u.shape[-1]
    half = (1 << max(n - 1, 0).bit_length()) // 2
    if half == 0:
        return (u * v)[..., 0]
    hi = Fnn.pad(u[..., half:] * v[..., half:], (0, 2 * half - n))
    lo_u, lo_v = u[..., :half], v[..., :half]
    x = fma(lo_u, lo_v, hi) if contract else lo_u * lo_v + hi
    while half > 1:
        half //= 2
        x = x[..., :half] + x[..., half:2 * half]
    return x[..., 0]


def refit_reference(tau: torch.Tensor, X: torch.Tensor, weight: torch.Tensor,
                    eps: float = 1e-12, contract: int = ALL_CONTRACTED) -> torch.Tensor:
    """The masked 2x2 normal-equation solve (..., 2) of the 0/1 ``weight``
    (..., P); ``tau`` broadcasts against it."""
    X0, X1 = X[:, 0], X[:, 1]
    wx0, wx1 = weight * X0, weight * X1
    wt = weight * tau
    m00, m01, m11, b0, b1 = (
        _tree_dot(u, v, bool(contract >> k & 1))
        for k, (u, v) in enumerate(((wx0, X0), (wx0, X1), (wx1, X1), (wt, X0), (wt, X1))))
    det = fma(m00, m11, -(m01 * m01))
    ok = det.float().abs() > eps
    safe = torch.where(ok, det, torch.ones_like(det))
    zero = torch.zeros_like(det)
    s0 = fma(b0, m11, -(b1 * m01)) / safe
    s1 = fma(b1, m00, -(b0 * m01)) / safe
    return torch.stack([torch.where(ok, s0, zero), torch.where(ok, s1, zero)], dim=-1)


def elemental_reference(tau: torch.Tensor, cand: torch.Tensor, Ainv: torch.Tensor) -> torch.Tensor:
    """The elemental solves s (..., Q, 2) of the candidate pairs cand (Q, 2)."""
    tp = tau[..., cand.long()]                        # (..., Q, 2)
    t0, t1 = tp[..., 0], tp[..., 1]
    return torch.stack([fma(Ainv[:, 0, 1], t1, Ainv[:, 0, 0] * t0),
                        fma(Ainv[:, 1, 1], t1, Ainv[:, 1, 0] * t0)], dim=-1)


def tree_sum_last(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis as a fixed halving tree of binary adds.

    Every reduction whose result the LTS sweep compares (rank selection,
    funnel and argmin objectives) goes through this, so that the card and
    the CPU, and every batch shape, add in one order and pick the same
    candidates.  Zero-padding to a power of two is exact.
    """
    n = x.shape[-1]
    p = 1 << max(n - 1, 0).bit_length()
    if p != n:
        x = Fnn.pad(x, (0, p - n))
    while p > 1:
        p //= 2
        x = x[..., :p] + x[..., p:2 * p]
    return x[..., 0]


def rank_keys(x: torch.Tensor) -> torch.Tensor:
    """int64 keys (..., P), all distinct, whose order is that of (value,
    index): x_j before x_i when x_j < x_i, or x_j == x_i and j < i.  NaN
    counts as +inf and -0.0 as +0.0; the bits of ``x`` as float32 map to a
    monotone int32 (negative values flip their magnitude bits), times P,
    plus the index."""
    x = x.float()    # a narrower float widens exactly, keeping its order
    x = torch.where(torch.isnan(x), torch.full_like(x, float("inf")), x) + 0.0
    b = x.contiguous().view(torch.int32)
    b = torch.where(b < 0, b ^ 0x7FFFFFFF, b)
    P = x.shape[-1]
    return b.to(torch.int64) * P + torch.arange(P, device=x.device)


def rank_along_last(x: torch.Tensor, against: torch.Tensor = None,
                    chunk_bytes: int = None) -> torch.Tensor:
    """Stable rank of each element along the last axis (0 = smallest).

    Pairwise comparison counts: NaNs rank last (as +inf), exact ties break
    by index (element j counts against i when x_j < x_i, or x_j == x_i and
    j < i), as a stable sort would.  One comparison a pair, of the
    distinct keys of `rank_keys`, counted over the middle axis of a
    (rows, j, i) boolean; the rows are taken in chunks whose temporaries
    fit ``chunk_bytes`` (default `RANK_CHUNK_BYTES`).  Rows are independent
    and counts are integers, so the chunking changes no result.  Counts are
    uint8 where P <= 255: no wider copy of the booleans is made to sum them.

    ``against`` (x's shape) holds the values x_j is read from where they
    differ from the ranked x_i (the one-band programs' objective,
    ``ops.lts``): then element i counts itself when against_i < x_i.
    """
    P = x.shape[-1]
    k = rank_keys(x).reshape(-1, P)
    kj = k if against is None or against is x else rank_keys(against).reshape(-1, P)
    cdt = torch.uint8 if P <= 255 else torch.int32
    step = max(1, (RANK_CHUNK_BYTES if chunk_bytes is None else chunk_bytes) // (P * P))
    out = torch.empty(k.shape, dtype=cdt, device=x.device)
    for r0 in range(0, k.shape[0], step):
        kc = k[r0:r0 + step]
        lt = kj[r0:r0 + step, :, None] < kc[:, None, :]   # [r, j, i]: key_j < key_i
        out[r0:r0 + step] = (lt.view(torch.uint8) if cdt == torch.uint8 else lt).sum(
            1, dtype=cdt)
    return out.reshape(x.shape)


def _role_residuals2(passes, tau, X, s, lag, inv_fs, roles, bits):
    """The squared residuals (..., Q, P) of the fits s for each role bit of
    ``bits``: from the lags where ``roles`` has the bit, else from the
    rounded delays, each computed once."""
    residuals2_fn, residuals2_lag_fn, _ = passes
    un = (residuals2_lag_fn(lag, inv_fs, X, s) if any(roles & b for b in bits)
          else None)
    rounded = (residuals2_fn(tau, X, s) if any(not roles & b for b in bits)
               else None)
    return tuple(un if roles & b else rounded for b in bits)


def sweep_reference(tau: torch.Tensor, X: torch.Tensor, s: torch.Tensor, h: int,
                    n_steps: int, contract: int = ALL_CONTRACTED, objective: bool = True,
                    lag: torch.Tensor = None, inv_fs: float = 0.0, roles: int = 0,
                    eps: float = 1e-12, *, passes=None):
    """The plain version of `sweep`: the C-steps and the trimmed objective
    as separate passes, (s (..., Q, 2), obj (..., Q) or None).

    Each C-step ranks the squared residuals of s (`rank_along_last`, the
    keys of role ``step.i`` ranked against those of ``step.j``), keeps the
    h smallest as 0/1 weights and refits (`refit_reference`, ``contract``).
    The objective ranks the residuals of the final s the same way (roles
    ``objective.i`` and ``objective.j``) and sums ``sel * r2`` with
    `tree_sum_last`, the leaves below half of the next power of two from
    role ``objective.lo``'s residuals and the others from
    ``objective.hi``'s; NaN -> inf.  A role whose bit is set in ``roles``
    (`ROLES`) takes its residuals from the lags (`residuals2_lag_reference`),
    else from tau (`residuals2_reference`).  ``passes`` replaces the three
    plain passes (residuals2, residuals2_lag, refit) by others of the same
    signatures, the kernels' wrappers for example.
    """
    if passes is None:
        passes = (residuals2_reference, residuals2_lag_reference, refit_reference)
    refit_fn = passes[2]
    bit = {r: 1 << k for k, r in enumerate(ROLES)}
    for _ in range(n_steps):
        r2i, r2j = _role_residuals2(passes, tau, X, s, lag, inv_fs, roles,
                                    (bit["step.i"], bit["step.j"]))
        weight = (rank_along_last(r2i, r2j) < h).to(tau.dtype)
        s = refit_fn(tau[..., None, :], X, weight, eps, contract)
    if not objective:
        return s, None
    r2i, r2j, lo, hi = _role_residuals2(passes, tau, X, s, lag, inv_fs, roles, tuple(
        bit[f"objective.{r}"] for r in ("i", "j", "lo", "hi")))
    sel = (rank_along_last(r2i, r2j) < h).to(tau.dtype)
    half = (1 << max(lo.shape[-1] - 1, 0).bit_length()) // 2
    v = lo if hi is lo else torch.cat([lo[..., :half], hi[..., half:]], dim=-1)
    obj = tree_sum_last(sel * v)                      # (..., Q)
    return s, torch.where(torch.isnan(obj), torch.full_like(obj, float("inf")), obj)


def _clamp_min(x: torch.Tensor, lo: float) -> torch.Tensor:
    """``torch.clamp(x, min=lo)`` against the float32 of ``lo``, rounded to
    x's dtype: a narrower dtype would round ``lo`` first on the card."""
    return torch.clamp(x.float(), min=lo).to(x.dtype)


def final_reference(tau: torch.Tensor, X: torch.Tensor, obj: torch.Tensor, s: torch.Tensor,
                    h: int, dof: int, contract: int = ALL_CONTRACTED, lag: torch.Tensor = None,
                    inv_fs: float = 0.0, roles: int = 0, eps: float = 1e-12) -> dict:
    """The plain version of `final`: the final subset of an LTS solve.

    Of the candidates' objectives obj (..., K) and fits s (..., K, 2) on tau
    (..., P): the first minimum (``torch.argmin``'s index; its objective
    ``obj[b]`` and fit ``s[b]``); the ranks of that fit's squared residuals
    (`rank_along_last`), retained = rank < h; the refit of the retained
    subset (`refit_reference`, ``contract``, ``eps``); sigma_tau = sqrt(
    `tree_sum_last` (w r2) / dof) on the refit's residuals; and the
    uncertainty ellipse of the retained co-array (its normal sums
    `tree_sum_last` of (w X_a) X_b), each operation rounded on its own.  A
    role bit of ``roles`` (`FINAL_ROLES`) takes that pass's residuals from
    the lags (`residuals2_lag_reference`).  Every scalar is taken as on the
    CPU, on either device: the division by dof is a true division, and a
    clamp's floor is the float32 of its constant.  Returns objective (...),
    s (..., 2), retained (..., P bool), sig_tau, vel_uncert and baz_uncert
    (...)."""
    passes = (residuals2_reference, residuals2_lag_reference, refit_reference)
    bit = {r: 1 << k for k, r in enumerate(FINAL_ROLES)}
    b = torch.argmin(obj, dim=-1, keepdim=True)
    s_best = s.gather(-2, b[..., None].expand(b.shape + (2,)))      # (..., 1, 2)
    r2, = _role_residuals2(passes, tau, X, s_best, lag, inv_fs, roles, (bit["final"],))
    retained = rank_along_last(r2[..., 0, :]) < h
    weight = retained.to(tau.dtype)
    s_fin = refit_reference(tau, X, weight, eps, contract)
    r2, = _role_residuals2(passes, tau, X, s_fin[..., None, :], lag, inv_fs, roles,
                           (bit["sigma2"],))
    sigma2 = tree_sum_last(weight * r2[..., 0, :]) / torch.full(
        (), dof, dtype=tau.dtype, device=tau.device)

    Xw = weight[..., None] * X
    m00 = tree_sum_last(Xw[..., 0] * X[..., 0])
    m01 = tree_sum_last(Xw[..., 0] * X[..., 1])
    m11 = tree_sum_last(Xw[..., 1] * X[..., 1])
    det = m00 * m11 - m01 * m01
    safe = torch.where(det.float().abs() > DET_EPS, det, torch.ones_like(det))
    i00, i01, i11 = m11 / safe, -m01 / safe, m00 / safe

    sx, sy = s_fin[..., 0], s_fin[..., 1]
    smag2 = _clamp_min(sx * sx + sy * sy, SMAG2_MIN)
    smag = torch.sqrt(smag2)
    gvx, gvy = -sx / (smag2 * smag), -sy / (smag2 * smag)
    var_v = sigma2 * (i00 * gvx * gvx + 2 * i01 * gvx * gvy + i11 * gvy * gvy)
    gtx, gty = -sy / smag2, sx / smag2
    var_t = sigma2 * (i00 * gtx * gtx + 2 * i01 * gtx * gty + i11 * gty * gty)
    baz_uncert = torch.sqrt(_clamp_min(var_t, 0.0))
    return {
        "objective": obj.gather(-1, b)[..., 0],
        "s": s_fin,
        "retained": retained,
        "sig_tau": torch.sqrt(sigma2),
        "vel_uncert": torch.sqrt(_clamp_min(var_v, 0.0)),
        "baz_uncert": torch.rad2deg(baz_uncert.float()).to(baz_uncert.dtype),
    }


# --------------------------------------------------------------------------
# dispatch
# --------------------------------------------------------------------------

def _check_cuda(name: str, *tensors: torch.Tensor) -> int:
    """The dtype code of the float tensors of a launch, after checking that
    they share a CUDA device and a dtype the kernels take."""
    dev, dt = tensors[0].device, tensors[0].dtype
    if dev.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu tensors, not {dev}")
    if dt not in _DTYPES:
        raise TypeError(f"{name} on the card takes float32, bfloat16 or float16; got {dt}")
    for t in tensors[1:]:
        if t.device != dev or t.dtype != dt:
            raise ValueError(f"{name}: every operand must be {dt} on {dev}; got "
                             f"{t.dtype} on {t.device}")
    return _DTYPES[dt]


def _launched(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def residuals2(tau: torch.Tensor, X: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Squared residuals (..., Q, P) of the fits s (..., Q, 2) to tau (..., P)
    through the co-array X (P, 2): on the card the kernel, on the CPU
    `residuals2_reference`."""
    global launches_residuals2
    if tau.device.type == "cpu":
        return residuals2_reference(tau, X, s)
    code = _check_cuda("lts_residuals2", tau, X, s)
    P, Q = tau.shape[-1], s.shape[-2]
    if s.shape[:-2] != tau.shape[:-1] or s.shape[-1] != 2 or X.shape != (P, 2):
        raise ValueError(f"lts_residuals2 needs tau (..., P), X (P, 2), s (..., Q, 2); "
                         f"got {tuple(tau.shape)}, {tuple(X.shape)}, {tuple(s.shape)}")
    tau_c, X_c, s_c = tau.contiguous(), X.contiguous(), s.contiguous()
    out = torch.empty(s.shape[:-1] + (P,), dtype=tau.dtype, device=tau.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(tau.device):
        _launched("lts_residuals2", _lib().nbls_lts_residuals2(
            code, tau_c.data_ptr(), X_c.data_ptr(), s_c.data_ptr(), out.data_ptr(),
            tau_c.numel() // P, Q, P, torch.cuda.current_stream(tau.device).cuda_stream))
    launches_residuals2 += 1
    return out


def residuals2_lag(lag: torch.Tensor, inv_fs: float, X: torch.Tensor,
                   s: torch.Tensor) -> torch.Tensor:
    """Squared residuals (..., Q, P) of the fits s (..., Q, 2) to the delays
    ``lag * inv_fs`` (lag (..., P), inv_fs rounded to float32), the delay's
    product contracted into the residual: on the card the kernel, on the
    CPU `residuals2_lag_reference`."""
    global launches_residuals2_lag
    inv_fs = float(torch.tensor(inv_fs, dtype=torch.float32))
    if lag.dtype != torch.float32:
        raise TypeError(f"lts_residuals2_lag takes float32 (only float32 programs "
                        f"contract); got {lag.dtype}")
    if lag.device.type == "cpu":
        return residuals2_lag_reference(lag, inv_fs, X, s)
    _check_cuda("lts_residuals2_lag", lag, X, s)
    P, Q = lag.shape[-1], s.shape[-2]
    if s.shape[:-2] != lag.shape[:-1] or s.shape[-1] != 2 or X.shape != (P, 2):
        raise ValueError(f"lts_residuals2_lag needs lag (..., P), X (P, 2), s (..., Q, 2); "
                         f"got {tuple(lag.shape)}, {tuple(X.shape)}, {tuple(s.shape)}")
    lag_c, X_c, s_c = lag.contiguous(), X.contiguous(), s.contiguous()
    out = torch.empty(s.shape[:-1] + (P,), dtype=lag.dtype, device=lag.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(lag.device):
        _launched("lts_residuals2_lag", _lib().nbls_lts_residuals2_lag(
            lag_c.data_ptr(), inv_fs, X_c.data_ptr(), s_c.data_ptr(), out.data_ptr(),
            lag_c.numel() // P, Q, P, torch.cuda.current_stream(lag.device).cuda_stream))
    launches_residuals2_lag += 1
    return out


def _refit_layout(tau: torch.Tensor, weight: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """tau as rows (R / q, P) and q, where row r of ``weight`` (R rows) takes
    tau row r // q: tau of weight's shape (q = 1), or with a length-1 axis
    where weight has its candidates (..., 1, P) against (..., Q, P)."""
    if tau.shape == weight.shape:
        return tau, 1
    if (tau.dim() == weight.dim() and tau.dim() >= 2 and tau.shape[-2] == 1
            and tau.shape[:-2] == weight.shape[:-2] and tau.shape[-1] == weight.shape[-1]):
        return tau[..., 0, :], weight.shape[-2]
    return tau.expand(weight.shape), 1


def refit(tau: torch.Tensor, X: torch.Tensor, weight: torch.Tensor,
          eps: float = 1e-12, contract: int = ALL_CONTRACTED) -> torch.Tensor:
    """The masked 2x2 normal-equation solve s (..., 2) of the 0/1 ``weight``
    (..., P), ``tau`` broadcast against it, the first tree level of the sums
    whose bit is set in ``contract`` contracted: on the card the kernel (one
    thread a row), on the CPU `refit_reference`."""
    global launches_refit
    if weight.device.type == "cpu":
        return refit_reference(tau, X, weight, eps, contract)
    code = _check_cuda("lts_refit", weight, tau, X)
    P = weight.shape[-1]
    if X.shape != (P, 2):
        raise ValueError(f"lts_refit needs X of shape ({P}, 2); got {tuple(X.shape)}")
    if P > MAX_P:
        raise ValueError(f"lts_refit on the card takes rows of at most {MAX_P} "
                         f"equations; got {P}")
    tau_rows, q = _refit_layout(tau, weight)
    tau_c, X_c, w_c = tau_rows.contiguous(), X.contiguous(), weight.contiguous()
    out = torch.empty(weight.shape[:-1] + (2,), dtype=weight.dtype, device=weight.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(weight.device):
        _launched("lts_refit", _lib().nbls_lts_refit(
            code, tau_c.data_ptr(), X_c.data_ptr(), w_c.data_ptr(), out.data_ptr(),
            w_c.numel() // P, q, P, eps, int(contract),
            torch.cuda.current_stream(weight.device).cuda_stream))
    launches_refit += 1
    return out


def elemental(tau: torch.Tensor, cand: torch.Tensor, Ainv: torch.Tensor) -> torch.Tensor:
    """The elemental solves s (..., Q, 2): ``Ainv[q] @ tau[..., cand[q]]``
    with the JAX package's contraction; on the card the kernel, on the CPU
    `elemental_reference`."""
    global launches_elemental
    if tau.device.type == "cpu":
        return elemental_reference(tau, cand, Ainv)
    code = _check_cuda("lts_elemental", tau, Ainv)
    P, Q = tau.shape[-1], cand.shape[0]
    if cand.shape != (Q, 2) or Ainv.shape != (Q, 2, 2):
        raise ValueError(f"lts_elemental needs cand (Q, 2) and Ainv (Q, 2, 2); got "
                         f"{tuple(cand.shape)}, {tuple(Ainv.shape)}")
    if cand.device != tau.device:
        raise ValueError(f"lts_elemental: cand on {cand.device}, tau on {tau.device}")
    tau_c, A_c = tau.contiguous(), Ainv.contiguous()
    cand_c = cand.to(torch.int64).contiguous()
    out = torch.empty(tau.shape[:-1] + (Q, 2), dtype=tau.dtype, device=tau.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(tau.device):
        _launched("lts_elemental", _lib().nbls_lts_elemental(
            code, tau_c.data_ptr(), cand_c.data_ptr(), A_c.data_ptr(), out.data_ptr(),
            tau_c.numel() // P, Q, P, torch.cuda.current_stream(tau.device).cuda_stream))
    launches_elemental += 1
    return out


def sweep_route(P: int, dtype: torch.dtype) -> str:
    """The route `sweep` takes on the card for rows of P equations of
    ``dtype``, as ``csrc/lts_sweep.cu::sweep`` picks it: "thread" (one
    thread a row, P in `THREAD_SIZES`, float32), "warp" (one warp a row, P
    <= `WARP_P`) or "block" (one block a row).  `sweep` raises where the
    launcher reports another route."""
    if P in THREAD_SIZES and dtype == torch.float32:
        return "thread"
    return "warp" if P <= WARP_P else "block"


def sweep(tau: torch.Tensor, X: torch.Tensor, s: torch.Tensor, h: int, n_steps: int,
          contract: int = ALL_CONTRACTED, objective: bool = True, lag: torch.Tensor = None,
          inv_fs: float = 0.0, roles: int = 0, eps: float = 1e-12):
    """The candidate sweep of the fits s (..., Q, 2) on tau (..., P) through
    the co-array X (P, 2): ``n_steps`` C-steps keeping the h smallest
    squared residuals, the refit's first levels contracted per
    ``contract``, then, when ``objective``, the trimmed objective.  Returns
    (s (..., Q, 2), obj (..., Q) or None).  ``roles`` (bits of `ROLES`)
    names the residuals taken from the unrounded delay ``lag * inv_fs``
    (lag tau's shape, float32).  On the card one launch on the route of
    `sweep_route` (one thread, one warp or one block a row, up to `MAX_P`
    equations), on the CPU `sweep_reference`."""
    global launches_sweep, launches_sweep_thread
    inv_fs = float(torch.tensor(inv_fs, dtype=torch.float32))
    if roles and (lag is None or lag.dtype != torch.float32):
        raise TypeError("lts_sweep: delay roles need float32 lags (only float32 programs "
                        f"contract); got {None if lag is None else lag.dtype}")
    if tau.device.type == "cpu":
        return sweep_reference(tau, X, s, h, n_steps, contract, objective, lag, inv_fs,
                               roles, eps)
    code = _check_cuda("lts_sweep", tau, X, s)
    P, Q = tau.shape[-1], s.shape[-2]
    if s.shape[:-2] != tau.shape[:-1] or s.shape[-1] != 2 or X.shape != (P, 2):
        raise ValueError(f"lts_sweep needs tau (..., P), X (P, 2), s (..., Q, 2); got "
                         f"{tuple(tau.shape)}, {tuple(X.shape)}, {tuple(s.shape)}")
    if P > MAX_P:
        raise ValueError(f"lts_sweep on the card takes rows of at most {MAX_P} "
                         f"equations; got {P}")
    if n_steps < 0:
        raise ValueError(f"lts_sweep: n_steps must be >= 0; got {n_steps}")
    lag_c = None
    if roles:
        if lag.shape != tau.shape or lag.device != tau.device:
            raise ValueError(f"lts_sweep: lag must be tau's shape on {tau.device}; got "
                             f"{tuple(lag.shape)} on {lag.device}")
        lag_c = lag.contiguous()
    tau_c, X_c, s_c = tau.contiguous(), X.contiguous(), s.contiguous()
    s_out = torch.empty_like(s_c)
    obj = (torch.empty(s.shape[:-1], dtype=tau.dtype, device=tau.device) if objective
           else None)
    if s_out.numel() == 0:
        return s_out, obj
    route = ctypes.c_int(-1)
    with torch.cuda.device(tau.device):
        _launched("lts_sweep", _lib().nbls_lts_sweep(
            code, tau_c.data_ptr(), X_c.data_ptr(), s_c.data_ptr(),
            None if lag_c is None else lag_c.data_ptr(), inv_fs, s_out.data_ptr(),
            None if obj is None else obj.data_ptr(), tau_c.numel() // P, Q, P, int(h),
            int(n_steps), int(contract), int(bool(objective)), int(roles), eps, 0,
            ctypes.byref(route), torch.cuda.current_stream(tau.device).cuda_stream))
    launches_sweep += 1
    launched = ROUTES[route.value]
    if launched == "thread":
        launches_sweep_thread += 1
    if launched != sweep_route(P, tau.dtype):
        raise RuntimeError(f"lts_sweep launched its {launched} route for {P} equations of "
                           f"{tau.dtype}; sweep_route says {sweep_route(P, tau.dtype)}")
    return s_out, obj


def final_route(P: int, dtype: torch.dtype) -> str:
    """The route of an LTS solve's final subset for rows of P equations of
    ``dtype``, the same on every device: "warp" (`final`, one warp a window,
    P <= `WARP_P` in a dtype the kernels take), else "passes" (the separate
    passes of ``ops.lts._final_passes``).  `final` raises where its launcher
    reports another route."""
    return "warp" if P <= WARP_P and dtype in _DTYPES else "passes"


def final(tau: torch.Tensor, X: torch.Tensor, obj: torch.Tensor, s: torch.Tensor, h: int,
          dof: int, contract: int = ALL_CONTRACTED, lag: torch.Tensor = None,
          inv_fs: float = 0.0, roles: int = 0, eps: float = 1e-12) -> dict:
    """The final subset of an LTS solve of the candidates' objectives obj
    (..., K) and fits s (..., K, 2) on tau (..., P) through the co-array X
    (P, 2): the first minimum, the retained subset (rank < h), its refit
    (``contract``, ``eps``), sigma_tau (over ``dof``) and the uncertainty
    ellipse; ``roles`` (bits of `FINAL_ROLES`) names the residuals taken
    from the unrounded delay ``lag * inv_fs`` (lag tau's shape, float32).
    Returns objective, s, retained, sig_tau, vel_uncert and baz_uncert.  On
    the card one launch, one warp a window (`final_route` "warp": P <=
    `WARP_P`), on the CPU `final_reference`."""
    global launches_final
    inv_fs = float(torch.tensor(inv_fs, dtype=torch.float32))
    if roles and (lag is None or lag.dtype != torch.float32):
        raise TypeError("lts_final: delay roles need float32 lags (only float32 programs "
                        f"contract); got {None if lag is None else lag.dtype}")
    if tau.device.type == "cpu":
        return final_reference(tau, X, obj, s, h, dof, contract, lag, inv_fs, roles, eps)
    code = _check_cuda("lts_final", tau, X, obj, s)
    P, K = tau.shape[-1], obj.shape[-1]
    if (obj.shape[:-1] != tau.shape[:-1] or s.shape != obj.shape + (2,) or X.shape != (P, 2)
            or K == 0):
        raise ValueError(f"lts_final needs tau (..., P), X (P, 2), obj (..., K), s (..., K, 2) "
                         f"with K > 0; got {tuple(tau.shape)}, {tuple(X.shape)}, "
                         f"{tuple(obj.shape)}, {tuple(s.shape)}")
    if final_route(P, tau.dtype) != "warp":
        raise ValueError(f"lts_final on the card takes rows of at most {WARP_P} equations; "
                         f"got {P} (ops.lts._final_passes takes longer rows)")
    lag_c = None
    if roles:
        if lag.shape != tau.shape or lag.device != tau.device:
            raise ValueError(f"lts_final: lag must be tau's shape on {tau.device}; got "
                             f"{tuple(lag.shape)} on {lag.device}")
        lag_c = lag.contiguous()
    tau_c, X_c, obj_c, s_c = tau.contiguous(), X.contiguous(), obj.contiguous(), s.contiguous()
    out = {"objective": torch.empty(obj.shape[:-1], dtype=tau.dtype, device=tau.device),
           "s": torch.empty(tau.shape[:-1] + (2,), dtype=tau.dtype, device=tau.device),
           "retained": torch.empty(tau.shape, dtype=torch.bool, device=tau.device)}
    for k in ("sig_tau", "vel_uncert", "baz_uncert"):
        out[k] = torch.empty_like(out["objective"])
    if tau.numel() == 0:
        return out
    route = ctypes.c_int(-1)
    with torch.cuda.device(tau.device):
        _launched("lts_final", _lib().nbls_lts_final(
            code, tau_c.data_ptr(), X_c.data_ptr(), obj_c.data_ptr(), s_c.data_ptr(),
            None if lag_c is None else lag_c.data_ptr(), inv_fs,
            *(out[k].data_ptr() for k in ("objective", "s", "retained", "sig_tau",
                                          "vel_uncert", "baz_uncert")),
            tau_c.numel() // P, K, P, int(h), int(dof), int(contract), int(roles), eps,
            ctypes.byref(route), torch.cuda.current_stream(tau.device).cuda_stream))
    launches_final += 1
    if ROUTES[route.value] != final_route(P, tau.dtype):
        raise RuntimeError(f"lts_final launched its {ROUTES[route.value]} route for {P} "
                           f"equations of {tau.dtype}; final_route says "
                           f"{final_route(P, tau.dtype)}")
    return out
