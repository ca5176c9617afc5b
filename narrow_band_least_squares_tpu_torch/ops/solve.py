"""Batched slowness inversion: closed-form 2-parameter least squares.

Port of ``narrow_band_least_squares_tpu/ops/solve.py``.  The co-array
system ``tau = X s`` has two unknowns, so the per-window ``lstsq`` of the
reference's solver is one product with a precomputed pseudo-inverse,
batched over every (band, window) cell.  sigma_tau and the 1-sigma
velocity/back-azimuth uncertainties come from the same residuals.  The LTS
primitives (`tree_sum_last`, `masked_refit`) and the retained-subset
normal inverses of its confidence ellipses live here too
(`tree_sum_last` is defined in `ops.kernels.lts_sweep`).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from narrow_band_least_squares_tpu_torch.ops.kernels import lts_sweep as LS
# The sweep's fixed-tree sum, defined beside the sweep's kernels (its plain
# version sums the objective with it), and a name of this module as in the
# JAX package.
from narrow_band_least_squares_tpu_torch.ops.kernels.lts_sweep import (  # noqa: F401
    tree_sum_last,
)

SIGMA_TAU_DOF_SHIFT = 2  # matches oracle.ltsva.SIGMA_TAU_DOF_SHIFT


def precompute_lstsq(X: np.ndarray) -> Dict[str, np.ndarray]:
    """Host-side constants for the batched solve: pinv and (X^T X)^-1."""
    XtX = X.T @ X
    XtX_inv = np.linalg.inv(XtX)
    pinv = XtX_inv @ X.T              # (2, P)
    return {"X": X, "pinv": pinv, "XtX_inv": XtX_inv}


def degrees(x: torch.Tensor) -> torch.Tensor:
    """Radians -> degrees in ``x``'s dtype, computed in float32: for a
    narrower dtype CUDA would round the factor 180/pi to that dtype and the
    CPU would not."""
    return torch.rad2deg(x.float()).to(x.dtype)


def vel_baz_from_slowness(s: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """s: (..., 2) slowness [s/km] -> (trace velocity [km/s], back-azimuth [deg]).

    ``vel`` is NaN where |s| = 0; ``baz`` lies in [0, 360) (``remainder``
    takes the sign of the divisor, as ``%`` does in JAX and NumPy).
    """
    sx, sy = s[..., 0], s[..., 1]
    smag = torch.sqrt(sx * sx + sy * sy)
    vel = torch.where(smag > 0, 1.0 / torch.clamp(smag, min=1e-30),
                      torch.full_like(smag, float("nan")))
    baz = torch.remainder(degrees(torch.atan2(-sx, -sy)), 360.0)
    return vel, baz


def _dot(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``einsum`` summed in float32, in ``b``'s dtype: a narrower dtype's
    products are summed in float32 and rounded once, on every device (as
    the JAX step's dots do; cuBLAS may otherwise reduce bfloat16 in part
    in bfloat16)."""
    return torch.einsum(eq, a.float(), b.float()).to(b.dtype)


def ols_solve(
    tau: torch.Tensor,       # (..., P)
    X: torch.Tensor,         # (P, 2)
    pinv: torch.Tensor,      # (2, P)
    XtX_inv: torch.Tensor,   # (2, 2)
) -> Dict[str, torch.Tensor]:
    """Batched OLS.  Returns vel, baz, sig_tau, vel_uncert, baz_uncert, s, resid."""
    P = tau.shape[-1]
    s = _dot("kp,...p->...k", pinv, tau)
    resid = tau - _dot("pk,...k->...p", X, s)
    dof = max(P - SIGMA_TAU_DOF_SHIFT, 1)
    sigma2 = torch.sum(resid * resid, dim=-1) / dof
    sig_tau = torch.sqrt(sigma2)
    vel, baz = vel_baz_from_slowness(s)
    vel_uncert, baz_uncert = uncertainties(s, sigma2, XtX_inv)
    return {
        "vel": vel, "baz": baz, "sig_tau": sig_tau,
        "vel_uncert": vel_uncert, "baz_uncert": baz_uncert,
        "s": s, "resid": resid,
    }


def uncertainties(
    s: torch.Tensor,         # (..., 2)
    sigma2: torch.Tensor,    # (...)
    XtX_inv: torch.Tensor,   # (2, 2)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """1-sigma vel/baz uncertainties: linearized slowness-ellipse propagation."""
    sx, sy = s[..., 0], s[..., 1]
    smag2 = torch.clamp(sx * sx + sy * sy, min=1e-30)
    smag = torch.sqrt(smag2)
    # cov = sigma2 * XtX_inv; quadratic forms g^T cov g
    a, b_, c = XtX_inv[0, 0], XtX_inv[0, 1], XtX_inv[1, 1]

    gvx = -sx / (smag2 * smag)
    gvy = -sy / (smag2 * smag)
    var_v = sigma2 * (a * gvx * gvx + 2 * b_ * gvx * gvy + c * gvy * gvy)

    gtx = -sy / smag2
    gty = sx / smag2
    var_t = sigma2 * (a * gtx * gtx + 2 * b_ * gtx * gty + c * gty * gty)

    return (torch.sqrt(torch.clamp(var_v, min=0.0)),
            degrees(torch.sqrt(torch.clamp(var_t, min=0.0))))


def chi2_ellipse_uncertainties(
    vel: np.ndarray,         # (...) trace velocity [km/s]
    baz: np.ndarray,         # (...) back-azimuth [deg]
    sig_tau: np.ndarray,     # (...) delay-residual RMS [s]
    XtX_inv: np.ndarray,     # (2, 2) or (..., 2, 2) normal-matrix inverse
    conf: float = 0.90,
) -> Tuple[np.ndarray, np.ndarray]:
    """Szuberla & Olson (2004) slowness-plane confidence-ellipse intervals.

    The (1 - conf) confidence region of the slowness estimate is the ellipse
    ``{ds : ds^T C^-1 ds <= 1}`` with
    ``C = chi2_ppf(conf, 2) * sig_tau^2 * (X^T X)^-1``
    (chi2_ppf(q, 2) = -2 ln(1 - q)).  The velocity interval comes from the
    ellipse's radial extent, the back-azimuth interval from its angular
    extent seen from the origin.  Host-side NumPy: the intervals are an
    API-boundary product.  ``XtX_inv`` is the full co-array's (OLS) or, per
    window, the retained subset's (LTS, `subset_normal_inverses`).
    """
    vel = np.asarray(vel, dtype=np.float64)
    baz = np.asarray(baz, dtype=np.float64)
    sig_tau = np.asarray(sig_tau, dtype=np.float64)
    XtX_inv = np.asarray(XtX_inv, dtype=np.float64)
    k = -2.0 * np.log1p(-float(conf))          # chi2.ppf(conf, 2)
    with np.errstate(divide="ignore", invalid="ignore"):
        smag = np.where(vel > 0, 1.0 / np.maximum(vel, 1e-30), np.inf)
    az = np.radians(baz)
    # s = -|s| (sin az, cos az); u = radial unit vector, t = tangential
    ux, uy = -np.sin(az), -np.cos(az)
    tx, ty = -uy, ux
    a = XtX_inv[..., 0, 0]
    b_ = XtX_inv[..., 0, 1]
    c = XtX_inv[..., 1, 1]
    C_scale = k * sig_tau * sig_tau
    d_r = np.sqrt(
        np.maximum(C_scale * (a * ux * ux + 2 * b_ * ux * uy + c * uy * uy), 0.0)
    )
    d_t = np.sqrt(
        np.maximum(C_scale * (a * tx * tx + 2 * b_ * tx * ty + c * ty * ty), 0.0)
    )
    lo = 1.0 / (smag + d_r)
    hi = np.where(smag > d_r, 1.0 / np.maximum(smag - d_r, 1e-30), np.inf)
    vel_ci = 0.5 * (hi - lo)                   # half-width of the interval
    with np.errstate(invalid="ignore"):
        baz_ci = np.degrees(np.arcsin(np.clip(d_t / smag, 0.0, 1.0)))
    baz_ci = np.where(d_t >= smag, 180.0, baz_ci)  # ellipse encloses origin
    return vel_ci, baz_ci


def subset_normal_inverses(
    X: np.ndarray,           # (P, 2) co-array
    keep: np.ndarray,        # (..., P) bool: rows retained per window
) -> np.ndarray:
    """Per-window ``inv(X_kept^T X_kept)`` for the LTS confidence ellipses.

    The vendored ``lts_array`` builds the Szuberla & Olson ellipse from the
    normal matrix of the RETAINED co-array rows, so windows with flagged
    elements get the wider ellipse their reduced geometry implies.
    Degenerate subsets (rank < 2, or fewer than 3 rows) fall back to the
    full-geometry inverse, as in the JAX package.  Host-side NumPy,
    vectorized over windows.
    """
    X = np.asarray(X, dtype=np.float64)
    keep = np.asarray(keep, dtype=bool)
    w = keep.astype(np.float64)                          # (..., P)
    m00 = np.einsum("...p,p->...", w, X[:, 0] * X[:, 0])
    m01 = np.einsum("...p,p->...", w, X[:, 0] * X[:, 1])
    m11 = np.einsum("...p,p->...", w, X[:, 1] * X[:, 1])
    det = m00 * m11 - m01 * m01
    full_inv = np.linalg.inv(X.T @ X)
    ok = (np.abs(det) > 1e-12) & (keep.sum(axis=-1) >= 3)
    safe = np.where(ok, det, 1.0)
    out = np.empty(keep.shape[:-1] + (2, 2), dtype=np.float64)
    out[..., 0, 0] = np.where(ok, m11 / safe, full_inv[0, 0])
    out[..., 0, 1] = np.where(ok, -m01 / safe, full_inv[0, 1])
    out[..., 1, 0] = out[..., 0, 1]
    out[..., 1, 1] = np.where(ok, m00 / safe, full_inv[1, 1])
    return out


def masked_refit(
    tau: torch.Tensor,       # (..., P)
    X: torch.Tensor,         # (P, 2)
    weight: torch.Tensor,    # (..., P) 0/1 subset weights
    eps: float = 1e-12,
    contract: int = LS.ALL_CONTRACTED,
) -> torch.Tensor:
    """Weighted 2x2 normal-equation solve, the LTS C-step refit.

    Returns s (..., 2); ``tau`` broadcasts against ``weight``.  Degenerate
    subsets (``|det| <= eps`` on the float32 determinant) return zeros;
    callers mask them out through the objective.  The bits are those of the
    JAX package's ``masked_refit`` inside its jitted ``lts_solve``, where
    XLA's CPU backend contracts multiply-adds: each of the five sums
    (m00 = sum w X0 X0, m01 = sum w X0 X1, m11 = sum w X1 X1, b0 = sum
    w tau X0, b1 = sum w tau X1) is a halving tree over the next power of
    two, zero-padded (`tree_sum_last`), whose first level is ``fma(u[i],
    v[i], u[i+h] * v[i+h])`` with ``u = w X0`` (or ``w X1``, ``w tau``) and
    ``v`` the co-array column, its later levels plain adds.  Where XLA's
    fusion puts that add in another basic block than the product, it is not
    contracted: ``contract`` has a bit for each sum
    (`ops.kernels.lts_sweep.SUMS`), set where the first level is a fused
    multiply-add (`ops.lts.refit_contractions` says where).  ``det =
    fma(m00, m11, -(m01 * m01))``, ``s0 = fma(b0, m11, -(b1 * m01)) / det``
    and ``s1 = fma(b1, m00, -(b0 * m01)) / det``; every other operation is
    rounded on its own.  On the card one kernel computes it
    (`ops.kernels.lts_sweep.refit`), on the CPU its plain version.
    """
    return LS.refit(tau, X, weight, eps, contract)
