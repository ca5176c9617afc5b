"""Filter bank: SOS design on host, application on the device.

Port of ``narrow_band_least_squares_tpu/ops/filters.py``.  The host design
(SciPy, float64) is the same code; the device application is the same
exact frequency-domain IIR: each band's SOS cascade is tabulated as a
truncated impulse response, the raw waveform is FFT'd once and multiplied
by every band's response, and the zero-phase (butter) mode is the finite
two-pass of ObsPy's ``zerophase=True``.  The FFTs are ``torch.fft`` calls.

`sosfilt_scan` / `filter_stream_scan` are the exact time-domain recurrence
that the JAX package keeps as the cross-check of `filter_bank_fft`; on the
card they run the port's own kernel (`ops.kernels.sosfilt`).  They compute
the float32 bits of the JAX package's compiled ``lax.scan``, whose body XLA
contracts: per section ``ys = fma(b0, y, z1)``, ``z1 = fma(b1, y, -(a1
ys)) + z2``, ``z2 = fma(b2, y, -(a2 ys))``, the products with the
section's input y unrounded and those with ys rounded (read from the
optimized IR for 1, 2 and 4 sections and the zero-phase pair,
``scripts/xla_contractions.py --sosfilt``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
from scipy import signal

from narrow_band_least_squares_tpu_torch.ops.kernels.sosfilt import sosfilt


# --------------------------------------------------------------------------
# Host-side design (SciPy; runs once per plan)
# --------------------------------------------------------------------------

def design_sos(filter_type: str, fmin: float, fmax: float, order: int,
               ripple: float, fs: float) -> np.ndarray:
    """Bandpass SOS design matching reference ``helpers.py:128,130``."""
    if not (0.0 < fmin < fmax < fs / 2):
        raise ValueError(
            f"band edges must satisfy 0 < FMIN < FMAX < Nyquist: "
            f"FMIN={fmin}, FMAX={fmax}, fs={fs} (Nyquist {fs / 2}); the "
            f"reference notes FMAX 'should not exceed Nyquist' (example.py:51)"
        )
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


def impulse_response(sos: np.ndarray, length: int) -> np.ndarray:
    """Float64 impulse response of the SOS cascade, length samples."""
    x = np.zeros(length)
    x[0] = 1.0
    return signal.sosfilt(sos, x)


def impulse_length(sos: np.ndarray, max_length: int,
                   rel_tol: float = 1e-7) -> int:
    """Samples until the impulse response decays below rel_tol of its peak.

    Capped at ``max_length`` (the signal length): beyond that a longer
    response cannot change the output within the signal support.
    """
    h = impulse_response(sos, max_length)
    peak = np.max(np.abs(h))
    if peak == 0.0:
        return 1
    above = np.nonzero(np.abs(h) > rel_tol * peak)[0]
    return int(above[-1]) + 1 if len(above) else 1


def taper_window(npts: int, max_percentage: float = 0.01) -> np.ndarray:
    """Two-sided Hann taper (ObsPy ``taper(max_percentage=0.01)`` semantics,
    applied at reference ``helpers.py:139``)."""
    wlen = int(npts * max_percentage)
    taper = np.ones(npts)
    if wlen > 0:
        sides = np.hanning(2 * wlen + 1)
        taper[:wlen] = sides[:wlen]
        taper[npts - wlen:] = sides[wlen + 1:]
    return taper


def next_pow2(n: int) -> int:
    return 1 << (int(n - 1)).bit_length()


def build_filter_bank(
    band_edges: list,
    filter_type: str,
    order: int,
    ripple: float,
    fs: float,
    npts: int,
    rel_tol: float = 1e-7,
) -> Tuple[np.ndarray, list, int]:
    """Design all narrow-band filters and tabulate their impulse responses.

    Returns ``(h_bank (B, L) float64, sos_list, L)`` where L is the longest
    needed impulse length across bands (the low bands ring longest).
    """
    sos_list = [
        design_sos(filter_type, lo, hi, order, ripple, fs)
        for (lo, hi) in band_edges
    ]
    lengths = [impulse_length(s, npts, rel_tol) for s in sos_list]
    L = max(lengths)
    h_bank = np.stack([impulse_response(s, L) for s in sos_list])
    return h_bank, sos_list, L


def sosfreqz_bank(sos_list, freq_resp_list: np.ndarray, fs: float):
    """Per-band complex frequency responses (host, SciPy).

    Mirrors the ``signal.sosfreqz(sos, freq_resp_list, fs=Fs)`` calls the
    reference makes per band (``narrow_band_least_squares.py:78``), returning
    complex (B, F) arrays with the reference's dtype convention.
    """
    B = len(sos_list)
    F = len(freq_resp_list)
    w_array = np.zeros((B, F), dtype=complex)
    h_array = np.zeros((B, F), dtype=complex)
    for b, sos in enumerate(sos_list):
        w, h = signal.sosfreqz(sos, freq_resp_list, fs=fs)
        w_array[b] = w
        h_array[b] = h
    return w_array, h_array


# --------------------------------------------------------------------------
# Device-side application
# --------------------------------------------------------------------------

def filter_bank_fft(
    x: torch.Tensor,               # (C, T) raw waveforms
    h_bank: torch.Tensor,          # (B, L) impulse responses
    taper: Optional[torch.Tensor],  # (T,) or None
    nfft: int,                     # >= next_pow2(T + L)
    zerophase: bool,               # butter: finite two-pass; cheby1: causal H
) -> torch.Tensor:
    """All bands at once: y[b, c] = taper * (x[c] * h[b]) (linear convolution).

    Zero-phase mode reproduces ObsPy's finite two-pass: the first causal
    pass is truncated to the T samples before the time-reversed second pass.
    Returns (B, C, T) in the dtype of ``x``.
    """
    T = x.shape[-1]
    Xf = torch.fft.rfft(x, n=nfft, dim=-1)               # (C, F)
    Hf = torch.fft.rfft(h_bank, n=nfft, dim=-1)          # (B, F)
    Yf = Xf[None, :, :] * Hf[:, None, :]                 # (B, C, F)
    y = torch.fft.irfft(Yf, n=nfft, dim=-1)[..., :T]
    if zerophase:
        Y2 = torch.fft.rfft(y.flip(-1), n=nfft, dim=-1)
        y = torch.fft.irfft(Y2 * Hf[:, None, :], n=nfft, dim=-1)[..., :T].flip(-1)
    if taper is not None:
        y = y * taper[None, None, :]
    return y


def sosfilt_scan(sos: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Exact SOS recurrence (transposed direct-form II) over the last axis.

    ``sos``: (S, 6); ``x``: (..., T).  Matches ``scipy.signal.sosfilt`` up
    to dtype.  On the card the `ops.kernels.sosfilt` kernel (float32), on
    the CPU its plain loop; the JAX package's ``lax.scan`` order of
    operations in both."""
    return sosfilt(sos, x)


def filter_stream_scan(
    x: torch.Tensor, sos: torch.Tensor, taper: torch.Tensor, zerophase: bool
) -> torch.Tensor:
    """Single-band exact filtering via the scan recurrence + taper."""
    y = sosfilt_scan(sos, x)
    if zerophase:
        y = sosfilt_scan(sos, y.flip(-1)).flip(-1)
    return y * taper
