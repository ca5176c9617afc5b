"""The LTS sweep's arithmetic with the JAX package's contractions,
``csrc/lts_sweep.cu``.

The port's own kernels, not the counterpart of a TPU kernel: the JAX
package's sweep (``narrow_band_least_squares_tpu/ops/lts.py``) is plain
XLA, and XLA's CPU backend contracts a multiply whose product feeds an add
inside one fusion into a fused multiply-add (one rounding).  The flags
hang on the last bits of the squared residuals, so the port computes the
same roundings, in four entry points:

- `residuals2` (``_residuals2`` and the final subset): ``r = tau -
  fma(X[p,1], s1, X[p,0] * s0)``, ``r2 = r * r``;
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
  Ainv[q,i,0] * t0)`` with ``t = tau[cand[q]]``.

Every other multiply, add and division is rounded on its own.  In a dtype
narrower than float32 nothing is contracted: each operation is taken in
float32 and rounded to the dtype, as PyTorch does (the JAX package's
narrow dtypes round where XLA's fusions end, which the port matches only
within their rounding, ``tests/test_torch_dtypes.py``).

A CUDA tensor goes to the kernel of its entry point, which counts a launch
in ``launches_residuals2``, ``launches_residuals2_lag``, ``launches_refit``
or ``launches_elemental``; a
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
launches_residuals2 = 0
launches_residuals2_lag = 0
launches_refit = 0
launches_elemental = 0

# Longest row `refit` takes on the card (P delay equations, 45 elements).
MAX_P = 1024
# The refit's five sums, in the bit order of ``contract``; every first
# level contracted:
SUMS = ("m00", "m01", "m11", "b0", "b1")
ALL_CONTRACTED = (1 << len(SUMS)) - 1
# dtype codes of the C interface
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

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
        for fn in (lib.nbls_lts_residuals2, lib.nbls_lts_residuals2_lag, lib.nbls_lts_refit,
                   lib.nbls_lts_elemental):
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
