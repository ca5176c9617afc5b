"""The plain reference that decides ``correct``: the frozen oracle's
semantics (`ltsva.sliding_window_solve` with its FFT correlation, ordinary
least squares) with the loop over windows turned into array operations, so
that a 1200 s segment of 50 bands takes about a second on one host core.

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

from typing import Dict, List, Optional, Tuple

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


class Deployment:
    """The band plan of one configuration file (its NBLSConfig keys)."""

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


def solve_band(filtered: np.ndarray, wp: WindowPlan, X: np.ndarray,
               pairs: np.ndarray, fs: float, start_epoch: float,
               device: str = "cpu") -> Dict[str, np.ndarray]:
    """Every window of one band at once: demean, FFT cross-correlation over
    all lags (first maximum), normalised peaks, MdCCM, the OLS slowness."""
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
                       pairs, dep.fs, start_epoch, device)
            for b in range(dep.nbands)]
