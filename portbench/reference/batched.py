"""The plain reference that decides ``correct``: the frozen oracle's
semantics (`ltsva.sliding_window_solve` with its FFT correlation, ordinary
least squares) with the loop over windows turned into array operations, so
that a 1200 s segment of 50 bands takes about a second on one host core.

With ``ALPHA < 1`` the solve is least trimmed squares (`lts_band`): every
elemental pair a candidate, ``c_steps`` concentration steps with no early
stop, the funnel where the configuration asks for it, the first minimum,
the final subset and its refit, all in float64 for every window at once.
It follows the port's documented algorithm (its defaults `LTS_C_STEPS`
and `LTS_FUNNEL_K`), and at ten steps without the funnel it equals the
frozen oracle's ``_lts_solve`` wherever that one's C-steps converge.  Its
``flags`` (W, P) are the dropped pairs.

Every number is float64 and worked out here from the raw samples: the
band edges, the filters (SciPy ``sosfilt``, the exact recurrence), the
taper, the window grid, the correlations, the solve.  Nothing of the
port is imported or read.  `tests/test_portbench_reference.py` holds it to
the copied per-window oracle.

A monitor's segment is filtered with the samples before it that the call
handed over (``context``), as a causal filter runs over a stream, and the
taper is applied to the segment alone.
"""

from __future__ import annotations

from itertools import combinations
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch
from scipy import signal

from portbench.reference.geometry import coarray, slowness_to_vel_baz
from portbench.reference.ltsva import SIGMA_TAU_DOF_SHIFT, design_sos, taper_window
from portbench.reference.plan import (
    WindowPlan,
    band_edges,
    get_freqlist,
    get_winlenlist,
)
from portbench.reference.timeutils import epoch_to_datenum

# windows correlated at once on the host: few enough that the spectra stay
# in cache (on the card a band's windows go at once)
WINDOW_BLOCK = 8

# The port's LTS defaults, NarrowBandPipeline's arguments ``c_steps`` and
# ``lts_funnel_k`` (the JAX package's): four C-steps, no funnel; a
# configuration's ``options`` may set either, and the funnel's 'auto' is
# `funnel_survivors`' rule
LTS_C_STEPS = 4
LTS_FUNNEL_K = 0
# |det| at or under this: an elemental pair or a subset is singular
LTS_DET_EPS = 1e-12
# (window, candidate, pair) elements an LTS block holds at once
LTS_BLOCK = 1 << 23


class Deployment:
    """The band plan of one configuration file (its NBLSConfig keys), and
    its solve: ``ALPHA``, and the LTS options of its ``options``."""

    def __init__(self, cfg: dict, npts: int):
        self.fs = float(cfg["FS"])
        self.npts = int(npts)
        self.freqlist, self.nbands, _ = get_freqlist(
            cfg["FMIN"], cfg["FMAX"], cfg["FREQ_BAND_TYPE"], cfg["NBANDS"])
        self.freq_band_type = cfg["FREQ_BAND_TYPE"]
        self.winlens = get_winlenlist(cfg["WINDOW_LENGTH_TYPE"], self.nbands,
                                      cfg["WINLEN"], cfg["WINLEN_1"], cfg["WINLEN_X"])
        self.winover = float(cfg["WINOVER"])
        self.filter = (cfg["FILTER_TYPE"], int(cfg["FILTER_ORDER"]),
                       float(cfg["FILTER_RIPPLE"]))
        self.windows = [WindowPlan.build(w, self.winover, self.npts, self.fs)
                        for w in self.winlens]
        self.sos = []
        for b in range(self.nbands):
            lo, hi = band_edges(self.freqlist, b, self.freq_band_type)
            ftype, order, ripple = self.filter
            self.sos.append(design_sos(ftype, lo, hi, order, ripple, self.fs))
        self.taper = taper_window(self.npts)
        self.alpha = float(cfg.get("ALPHA", 1.0))
        options = cfg.get("options", {})
        self.c_steps = int(options.get("c_steps", LTS_C_STEPS))
        self.funnel = options.get("lts_funnel_k", LTS_FUNNEL_K)

    @property
    def num_compute_list(self) -> List[int]:
        return [wp.n_windows for wp in self.windows]


def filter_band(dep: Deployment, b: int, data: np.ndarray,
                context: Optional[np.ndarray] = None) -> np.ndarray:
    """Band ``b`` of a segment (C, T): the filter run from the first sample
    of ``context`` (C, H) through the segment, the segment's part tapered."""
    x = data if context is None else np.concatenate([context, data], axis=1)
    ftype = dep.filter[0]
    y = signal.sosfilt(dep.sos[b], x, axis=-1)
    if ftype == "butter":
        y = signal.sosfilt(dep.sos[b], y[:, ::-1], axis=-1)[:, ::-1]
    return y[:, x.shape[1] - data.shape[1]:] * dep.taper[None, :]


def correlate_peaks(win: np.ndarray, pairs: np.ndarray,
                    device: str = "cpu") -> Tuple[np.ndarray, np.ndarray]:
    """Demeaned windows (W, C, L) -> per (window, pair) the maximum of the
    full cross-correlation ``sum_t x_j(t + l) x_i(t)`` over the lags
    ``-(L-1)..L-1`` and its first lag in ascending order, in float64
    (PyTorch's FFT, on ``device``)."""
    W, _, L = win.shape
    nfft = 1 << int(np.ceil(np.log2(2 * L)))
    block = WINDOW_BLOCK if device == "cpu" else W
    ii = torch.as_tensor(pairs[:, 0], device=device)
    jj = torch.as_tensor(pairs[:, 1], device=device)
    peaks, lags = [], []
    for w0 in range(0, W, block):
        x = torch.as_tensor(win[w0:w0 + block], dtype=torch.float64).to(device)
        Wf = torch.fft.rfft(x, n=nfft, dim=-1)
        cc = torch.fft.irfft(Wf[:, jj] * torch.conj(Wf[:, ii]), n=nfft, dim=-1)
        # lags -(L-1)..-1 lie at the end of the circular result, 0..L-1 at
        # its start; the first maximum in ascending lag order is the
        # negative half's unless the other half holds a larger value
        vn, kn = torch.max(cc[..., nfft - (L - 1):], dim=-1)
        vp, kp = torch.max(cc[..., :L], dim=-1)
        first = vn >= vp
        peaks.append(torch.where(first, vn, vp))
        lags.append(torch.where(first, kn - (L - 1), kp))
    return (torch.cat(peaks).cpu().numpy(), torch.cat(lags).cpu().numpy())


def lts_h(alpha: float, P: int) -> int:
    """Equations kept: floor(alpha P), clamped to [3, P]."""
    return max(3, min(int(np.floor(alpha * P)), P))


def funnel_survivors(setting, Q: int) -> int:
    """The candidates the funnel keeps after its first C-step: 'auto' is
    max(16, ceil(Q / 24)) (the port's ``lts_funnel_k='auto'``), 0 none."""
    return max(16, -(-Q // 24)) if setting == "auto" else int(setting)


def _smallest(r2: torch.Tensor, h: int) -> torch.Tensor:
    """The h smallest along the last axis, ties to the lower index (bool)."""
    idx = torch.sort(r2, dim=-1, stable=True).indices[..., :h]
    return torch.zeros_like(r2, dtype=torch.bool).scatter_(-1, idx, True)


def _refit(tau: torch.Tensor, X: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
    """Least squares over the kept equations: tau and keep (..., P) -> s
    (..., 2); a singular subset gives 0."""
    w = keep.to(tau.dtype)
    x0, x1 = X[:, 0], X[:, 1]
    m00, m01, m11 = (w * x0 * x0).sum(-1), (w * x0 * x1).sum(-1), (w * x1 * x1).sum(-1)
    b0, b1 = (w * tau * x0).sum(-1), (w * tau * x1).sum(-1)
    det = m00 * m11 - m01 * m01
    ok = det.abs() > LTS_DET_EPS
    safe = torch.where(ok, det, torch.ones_like(det))
    s = torch.stack([(b0 * m11 - b1 * m01) / safe, (b1 * m00 - b0 * m01) / safe], dim=-1)
    return torch.where(ok[..., None], s, torch.zeros_like(s))


def _residuals2(tau: torch.Tensor, X: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Squared residuals (W, K, P) of the fits s (W, K, 2)."""
    return (tau[:, None, :] - s @ X.T) ** 2


def _c_step(tau, X, s, h):
    """One concentration step: the refit of each fit's h best equations."""
    return _refit(tau[:, None, :], X, _smallest(_residuals2(tau, X, s), h))


def _trimmed(tau, X, s, h):
    """The sum of each fit's h smallest squared residuals (NaN: inf)."""
    obj = torch.sort(_residuals2(tau, X, s), dim=-1).values[..., :h].sum(-1)
    return torch.nan_to_num(obj, nan=float("inf"))


def lts_band(tau: np.ndarray, X: np.ndarray, h: int, c_steps: int, funnel_k: int,
             device: str = "cpu") -> Dict[str, np.ndarray]:
    """Least trimmed squares of every window (W, P) at once, in float64 on
    ``device``: each elemental pair's exact solve (|det| <= `LTS_DET_EPS`:
    not a candidate), ``c_steps`` C-steps on every candidate, or with
    ``funnel_k`` one on every candidate and the rest on the ``funnel_k``
    best by trimmed objective (ties to the lower index), the first minimum
    of the objectives, the h equations of smallest residual under its fit
    (ties to the lower index), their refit and sigma_tau = sqrt(r.r / (h -
    2)).  Returns vel, baz, sig_tau (W,) and flags (W, P): True where the
    pair was dropped."""
    P = X.shape[0]
    cand = torch.tensor(list(combinations(range(P), 2)), device=device)      # (Q, 2)
    Xt = torch.as_tensor(X, dtype=torch.float64, device=device)
    A = Xt[cand]                                                              # (Q, 2, 2)
    det = A[:, 0, 0] * A[:, 1, 1] - A[:, 0, 1] * A[:, 1, 0]
    ok = det.abs() > LTS_DET_EPS
    safe = torch.where(ok, det, torch.ones_like(det))
    Q = len(cand)
    funnel = bool(funnel_k) and funnel_k < Q and c_steps > 1
    inf = torch.tensor(float("inf"), dtype=torch.float64, device=device)
    rows = max(1, LTS_BLOCK // (Q * P))
    blocks = []
    for w0 in range(0, len(tau), rows):
        t = torch.as_tensor(tau[w0:w0 + rows], dtype=torch.float64, device=device)
        b = t[:, cand]                                                        # (W, Q, 2)
        s = torch.stack([(b[..., 0] * A[:, 1, 1] - b[..., 1] * A[:, 0, 1]) / safe,
                         (b[..., 1] * A[:, 0, 0] - b[..., 0] * A[:, 1, 0]) / safe], dim=-1)
        s = torch.where(ok[:, None], s, torch.zeros_like(s))
        if funnel:
            s = _c_step(t, Xt, s, h)
            obj = torch.where(ok, _trimmed(t, Xt, s, h), inf)
            best = torch.sort(obj, dim=-1, stable=True).indices[:, :funnel_k]
            s = s.gather(1, best[..., None].expand(-1, -1, 2))
            for _ in range(c_steps - 1):
                s = _c_step(t, Xt, s, h)
            obj = _trimmed(t, Xt, s, h)
        else:
            for _ in range(c_steps):
                s = _c_step(t, Xt, s, h)
            obj = torch.where(ok, _trimmed(t, Xt, s, h), inf)
        first = torch.argmin(obj, dim=-1)                                     # first minimum
        s_best = s[torch.arange(len(t), device=device), first]               # (W, 2)
        kept = _smallest(_residuals2(t, Xt, s_best[:, None, :])[:, 0], h)
        s_fin = _refit(t, Xt, kept)
        r = t - s_fin @ Xt.T
        sig_tau = torch.sqrt((kept * r * r).sum(-1) / max(h - SIGMA_TAU_DOF_SHIFT, 1))
        blocks.append((s_fin, kept, sig_tau))
    s_fin, kept, sig_tau = (torch.cat(x).cpu().numpy() for x in zip(*blocks))
    vel, baz = slowness_to_vel_baz(s_fin[:, 0], s_fin[:, 1])
    return {"vel": vel, "baz": baz, "sig_tau": sig_tau, "flags": ~kept}


def solve_band(filtered: np.ndarray, wp: WindowPlan, X: np.ndarray,
               pairs: np.ndarray, fs: float, start_epoch: float,
               device: str = "cpu", alpha: float = 1.0, c_steps: int = LTS_C_STEPS,
               funnel: Union[int, str] = LTS_FUNNEL_K) -> Dict[str, np.ndarray]:
    """Every window of one band at once: demean, FFT cross-correlation over
    all lags (first maximum), normalised peaks, MdCCM, the OLS slowness, or
    with ``alpha < 1`` the LTS slowness (`lts_band`), whose result also
    holds ``flags`` (W, P) and the ``pairs`` (P, 2) they index."""
    L = wp.winlensamp
    starts = np.asarray(wp.starts)
    win = filtered[:, starts[:, None] + np.arange(L)[None, :]]      # (C, W, L)
    win = np.transpose(win, (1, 0, 2))
    win = win - win.mean(axis=-1, keepdims=True)
    energies = np.sum(win ** 2, axis=-1)                              # (W, C)
    peak, lag = correlate_peaks(win, pairs, device)
    tau = lag / fs
    denom = np.sqrt(energies[:, pairs[:, 0]] * energies[:, pairs[:, 1]])
    rho = np.where(denom > 0, peak / np.where(denom > 0, denom, 1.0), 0.0)
    mdccm = np.median(rho, axis=-1)
    if alpha < 1.0:
        P = len(pairs)
        out = lts_band(tau, X, lts_h(alpha, P), c_steps,
                       funnel_survivors(funnel, P * (P - 1) // 2), device)
        out.update(mdccm=mdccm, t=epoch_to_datenum(wp.end_times_epoch(start_epoch, fs)),
                   pairs=pairs)
        return out

    XtX_inv = np.linalg.inv(X.T @ X)
    s = tau @ (XtX_inv @ X.T).T                                       # (W, 2)
    r = tau - s @ X.T
    sigma2 = np.sum(r * r, axis=-1) / max(len(pairs) - SIGMA_TAU_DOF_SHIFT, 1)
    vel, baz = slowness_to_vel_baz(s[:, 0], s[:, 1])
    t = epoch_to_datenum(wp.end_times_epoch(start_epoch, fs))
    return {"vel": vel, "baz": baz, "mdccm": mdccm, "t": t,
            "sig_tau": np.sqrt(sigma2)}


def solve_segment(dep: Deployment, rij: np.ndarray, data: np.ndarray,
                  start_epoch: float, context: Optional[np.ndarray] = None,
                  device: str = "cpu") -> List[Dict[str, np.ndarray]]:
    """One segment (C, npts) -> per band the dict of `solve_band`."""
    if data.shape[1] != dep.npts:
        raise ValueError(f"segment of {data.shape[1]} samples, plan of {dep.npts}")
    X, pairs = coarray(rij)
    return [solve_band(filter_band(dep, b, data, context), dep.windows[b], X,
                       pairs, dep.fs, start_epoch, device, dep.alpha, dep.c_steps,
                       dep.funnel)
            for b in range(dep.nbands)]
