# Frozen copy of narrow_band_least_squares_tpu_torch/oracle/ltsva.py (all but the
# 8-tuple wrapper ltsva_oracle) at
# commit 3ee1e9bea504232cbf251ade8fbcb464f796f707, with its imports
# rewritten to portbench.reference.  The benchmark's yardstick: later
# changes to the port do not move it.  Edit it only with the benchmark.
"""CPU oracle: the full reference semantics in plain NumPy/SciPy.

The port's own copy of ``narrow_band_least_squares_tpu/oracle/ltsva.py``,
line for line: the port imports nothing of the JAX package, and the oracle
imports neither torch nor JAX, so it runs on any machine as the float64
ground truth of the card's results (``chip_smoke.py``).

The reference's numerical core lives in the vendored ``lts_array`` submodule
(empty in the snapshot); its behavior is reconstructed here from its exact
call contract (reference ``example.py:109``,
``narrow_band_least_squares.py:91,183``) and the methods papers it cites
(Bishop, Fee & Szuberla 2020 GJI for LS/LTS; Szuberla & Olson 2004 for
sigma_tau and the uncertainty ellipse; Rousseeuw & Van Driessen FAST-LTS).

This module is the *golden reference* for the device path: slow, loopy,
obvious, and torch/jax-free.  Every convention the device kernels must reproduce is
defined here:

- window grid: ``winlensamp = int(winlen_s * fs)``,
  ``hop = int((1 - winover) * winlensamp)``, all fully-contained windows;
  the window timestamp is the window **end** (epoch -> matplotlib datenum).
- delays: for pair ``p=(i,j)``, ``tau_p = argmax_l sum_t x_j(t+l) x_i(t) / fs``
  over integer lags ``l`` in ``[-(L-1), L-1]`` ascending (np.correlate 'full'
  ordering, first-max tie-break), windows demeaned first.
- MdCCM: median over pairs of the normalized cross-correlation maximum.
- OLS (ALPHA == 1): ``s = pinv(X) tau``; trace velocity ``1/|s|`` [km/s];
  back-azimuth toward the source, degrees clockwise from north;
  ``sigma_tau = sqrt(r.r / (P - 2))``.
- LTS (0.5 <= ALPHA < 1): ``h = floor(ALPHA * P)`` (clamped to >= 3)
  equations retained; exact enumeration of all C(P,2) elemental 2-subsets
  (the slowness dimension is 2, so elemental subsets are pairs — exhaustive
  enumeration dominates randomized FAST-LTS here) followed by concentration
  C-steps; flagged (dropped) pairs land in ``stdict`` keyed by the
  7-decimal stringified window datenum, values = 1-based element numbers,
  one entry per flagged pair touching the element, plus a ``'size'`` key
  (contract pinned by reference ``plotting.py:136-137,923-941``).
"""

from __future__ import annotations

from itertools import combinations
from typing import Dict, Optional, Tuple

import numpy as np
from scipy import signal

from portbench.reference.geometry import (
    coarray,
    slowness_to_vel_baz,
)
from portbench.reference.plan import WindowPlan
from portbench.reference.timeutils import (
    epoch_to_datenum,
    stdict_timestamp_key,
)

SIGMA_TAU_DOF_SHIFT = 2  # LS dof = P - 2 (two slowness parameters)


# --------------------------------------------------------------------------
# Filtering (reference helpers.py:108-141 semantics)
# --------------------------------------------------------------------------

def design_sos(filter_type: str, fmin: float, fmax: float, order: int,
               ripple: float, fs: float) -> np.ndarray:
    """Bandpass SOS design, same scipy calls as reference helpers.py:128,130."""
    if filter_type == "butter":
        return signal.iirfilter(
            order, [fmin, fmax], btype="band", ftype="butter", fs=fs,
            output="sos",
        )
    if filter_type == "cheby1":
        return signal.iirfilter(
            order, [fmin, fmax], rp=ripple, btype="band", analog=False,
            ftype="cheby1", fs=fs, output="sos",
        )
    raise ValueError(f"Unknown FILTER_TYPE {filter_type!r}")


def taper_window(npts: int, max_percentage: float = 0.01) -> np.ndarray:
    """Two-sided Hann taper covering ``max_percentage`` of each end.

    Matches ObsPy's ``Stream.taper(max_percentage=0.01)`` applied at reference
    ``helpers.py:139`` (Hann sides of length ``int(npts * pct)``).
    """
    wlen = int(npts * max_percentage)
    taper = np.ones(npts)
    if wlen > 0:
        sides = np.hanning(2 * wlen + 1)
        taper[:wlen] = sides[:wlen]
        taper[npts - wlen:] = sides[wlen + 1:]
    return taper


def filter_and_taper(
    data: np.ndarray, fs: float, filter_type: str, fmin: float, fmax: float,
    order: int, ripple: float,
) -> Tuple[np.ndarray, np.ndarray]:
    """Bandpass + 1% taper, preserving the reference's behavioral asymmetry.

    'butter' is applied two-pass zero-phase (forward, then reversed, like
    ObsPy ``zerophase=True`` at helpers.py:127); 'cheby1' is applied causally
    per trace (helpers.py:130-137).  The taper always follows (helpers.py:139).
    Returns (filtered (C, T), sos).
    """
    sos = design_sos(filter_type, fmin, fmax, order, ripple, fs)
    out = np.empty_like(data, dtype=np.float64)
    for c in range(data.shape[0]):
        y = signal.sosfilt(sos, data[c])
        if filter_type == "butter":
            y = signal.sosfilt(sos, y[::-1])[::-1]
        out[c] = y
    out *= taper_window(data.shape[1])[None, :]
    return out, sos


# --------------------------------------------------------------------------
# Per-window delay estimation + inversion
# --------------------------------------------------------------------------

def _xcorr_delays(win: np.ndarray, pairs: np.ndarray, fs: float,
                  method: str = "time"):
    """Integer-lag delays and normalized cc maxima for one window.

    win: (C, L) demeaned window.  Returns (tau (P,), rho (P,)).

    ``method='time'`` is the O(L^2) ``np.correlate`` loop (bitwise-stable
    golden).  ``method='fft'`` is the honest fast-CPU baseline: one rFFT per
    channel, vectorized cross-spectra over all pairs, one batched irFFT —
    the same algorithm the real ``lts_array`` uses (SURVEY §3.4 "FFT-based").
    Peaks agree with 'time' up to FFT roundoff on near-ties.
    """
    C, L = win.shape
    energies = np.sum(win**2, axis=1)
    if method == "fft":
        nfft = 1 << int(np.ceil(np.log2(2 * L)))
        Wf = np.fft.rfft(win, n=nfft, axis=-1)                 # (C, F)
        cs = Wf[pairs[:, 1]] * np.conj(Wf[pairs[:, 0]])        # (P, F)
        cc = np.fft.irfft(cs, n=nfft, axis=-1)                 # circular
        # circular -> linear 'full' ordering [-(L-1) .. L-1]
        cc_lin = np.concatenate(
            [cc[:, nfft - (L - 1):], cc[:, :L]], axis=-1
        )
        k = np.argmax(cc_lin, axis=-1)
        peak = cc_lin[np.arange(len(pairs)), k]
        tau = (k - (L - 1)) / fs
        denom = np.sqrt(energies[pairs[:, 0]] * energies[pairs[:, 1]])
        rho = np.where(denom > 0, peak / np.where(denom > 0, denom, 1.0), 0.0)
        return tau, rho
    tau = np.zeros(len(pairs))
    rho = np.zeros(len(pairs))
    for p, (i, j) in enumerate(pairs):
        cc = np.correlate(win[j], win[i], mode="full")  # lags -(L-1)..(L-1)
        k = int(np.argmax(cc))
        lag = k - (L - 1)
        tau[p] = lag / fs
        denom = np.sqrt(energies[i] * energies[j])
        rho[p] = cc[k] / denom if denom > 0 else 0.0
    return tau, rho


def _ols_solve(X: np.ndarray, tau: np.ndarray):
    """Closed-form 2-parameter least squares.  Returns (s, resid, sigma_tau, cov)."""
    P = X.shape[0]
    XtX = X.T @ X
    XtX_inv = np.linalg.inv(XtX)
    s = XtX_inv @ (X.T @ tau)
    r = tau - X @ s
    dof = max(P - SIGMA_TAU_DOF_SHIFT, 1)
    sigma2 = float(r @ r) / dof
    sigma_tau = np.sqrt(sigma2)
    cov = sigma2 * XtX_inv
    return s, r, sigma_tau, cov


def _uncertainties(s: np.ndarray, cov: np.ndarray) -> Tuple[float, float]:
    """1-sigma velocity/back-azimuth uncertainties from the slowness covariance.

    Linearized propagation of the Szuberla & Olson 2004 slowness-plane
    ellipse through v = 1/|s| and theta = atan2(-sx, -sy).
    """
    sx, sy = s
    smag2 = sx**2 + sy**2
    if smag2 <= 0:
        return np.nan, np.nan
    smag = np.sqrt(smag2)
    g_v = -s / smag**3                       # d(1/|s|)/ds
    var_v = float(g_v @ cov @ g_v)
    g_th = np.array([-sy, sx]) / smag2       # d theta / d(sx, sy) [rad]
    var_th = float(g_th @ cov @ g_th)
    return np.sqrt(max(var_v, 0.0)), np.degrees(np.sqrt(max(var_th, 0.0)))


def _lts_solve(X: np.ndarray, tau: np.ndarray, alpha: float, c_steps: int = 10):
    """Exact-enumeration LTS for the 2-D slowness problem.

    Returns (s, retained_mask (P,), sigma_tau, cov).  ``retained_mask`` is
    True for the h equations in the optimal subset; flagged pairs are the
    complement.
    """
    P = X.shape[0]
    h = int(np.floor(alpha * P))
    h = max(3, min(h, P))

    cand = np.array(list(combinations(range(P), 2)), dtype=np.int64)  # (Q, 2)
    A = X[cand]                             # (Q, 2, 2)
    b = tau[cand]                           # (Q, 2)
    det = A[:, 0, 0] * A[:, 1, 1] - A[:, 0, 1] * A[:, 1, 0]
    ok = np.abs(det) > 1e-12
    s_cand = np.full((len(cand), 2), np.nan)
    safe_det = np.where(ok, det, 1.0)
    s_cand[:, 0] = (b[:, 0] * A[:, 1, 1] - b[:, 1] * A[:, 0, 1]) / safe_det
    s_cand[:, 1] = (b[:, 1] * A[:, 0, 0] - b[:, 0] * A[:, 1, 0]) / safe_det
    s_cand[~ok] = 0.0

    best_obj = np.inf
    best_subset = None
    for q in range(len(cand)):
        if not ok[q]:
            continue
        s = s_cand[q]
        subset = None
        for _ in range(c_steps):
            r2 = (tau - X @ s) ** 2
            new_subset = np.argsort(r2, kind="stable")[:h]
            new_subset.sort()
            if subset is not None and np.array_equal(new_subset, subset):
                break
            subset = new_subset
            Xs, ts = X[subset], tau[subset]
            XtX = Xs.T @ Xs
            if abs(np.linalg.det(XtX)) < 1e-14:
                break
            s = np.linalg.inv(XtX) @ (Xs.T @ ts)
        if subset is None:
            continue
        obj = float(np.sum((tau[subset] - X[subset] @ s) ** 2))
        if obj < best_obj:
            best_obj = obj
            best_subset = subset

    if best_subset is None:  # fully degenerate geometry; fall back to OLS
        s, r, sigma_tau, cov = _ols_solve(X, tau)
        return s, np.ones(P, dtype=bool), sigma_tau, cov

    mask = np.zeros(P, dtype=bool)
    mask[best_subset] = True
    Xs, ts = X[best_subset], tau[best_subset]
    XtX_inv = np.linalg.inv(Xs.T @ Xs)
    s = XtX_inv @ (Xs.T @ ts)
    r = ts - Xs @ s
    dof = max(h - SIGMA_TAU_DOF_SHIFT, 1)
    sigma2 = float(r @ r) / dof
    cov = sigma2 * XtX_inv
    return s, mask, np.sqrt(sigma2), cov


# --------------------------------------------------------------------------
# Sliding-window driver (the ltsva contract)
# --------------------------------------------------------------------------

def sliding_window_solve(
    filtered: np.ndarray,
    rij: np.ndarray,
    fs: float,
    start_epoch: float,
    winlen_s: float,
    winover: float,
    alpha: float,
    xcorr_method: str = "time",
) -> Dict[str, object]:
    """Slide windows over pre-filtered traces and solve each one.

    Returns a dict with vel, baz, t (matplotlib datenums), mdccm, sig_tau,
    vel_uncert, baz_uncert (all (W,) float arrays), flags ((W, P) bool,
    all-False for OLS), stdict (LTS only, else None), pairs, and the window
    plan.
    """
    C, T = filtered.shape
    X, pairs = coarray(rij)
    P = len(pairs)
    plan = WindowPlan.build(winlen_s, winover, T, fs)
    W = plan.n_windows
    t_epoch = plan.end_times_epoch(start_epoch, fs)
    t_datenum = epoch_to_datenum(t_epoch)

    vel = np.zeros(W)
    baz = np.zeros(W)
    mdccm = np.zeros(W)
    sig_tau = np.zeros(W)
    vel_uncert = np.zeros(W)
    baz_uncert = np.zeros(W)
    flags = np.zeros((W, P), dtype=bool)

    for w, s0 in enumerate(plan.starts):
        win = filtered[:, s0:s0 + plan.winlensamp]
        win = win - win.mean(axis=1, keepdims=True)
        tau, rho = _xcorr_delays(win, pairs, fs, method=xcorr_method)
        mdccm[w] = np.median(rho)
        if alpha == 1.0:
            s, r, st, cov = _ols_solve(X, tau)
        else:
            s, mask, st, cov = _lts_solve(X, tau, alpha)
            flags[w] = ~mask
        v, bz = slowness_to_vel_baz(s[0], s[1])
        vel[w], baz[w], sig_tau[w] = v, bz, st
        vel_uncert[w], baz_uncert[w] = _uncertainties(s, cov)

    stdict: Optional[Dict[str, object]] = None
    if alpha < 1.0:
        stdict = {}
        for w in range(W):
            flagged = np.where(flags[w])[0]
            elements = []
            for p in flagged:
                i, j = pairs[p]
                elements.extend([int(i) + 1, int(j) + 1])
            stdict[stdict_timestamp_key(t_datenum[w])] = np.asarray(
                elements, dtype=np.int64
            )
        stdict["size"] = C

    return {
        "vel": vel, "baz": baz, "t": t_datenum, "mdccm": mdccm,
        "sig_tau": sig_tau, "vel_uncert": vel_uncert,
        "baz_uncert": baz_uncert, "flags": flags, "stdict": stdict,
        "pairs": pairs, "plan": plan, "X": X,
    }
