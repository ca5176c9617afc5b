"""Fused window extraction, cross-correlation and peak search per bucket.

Port of ``narrow_band_least_squares_tpu/ops/kernels/fused_xcorr.py::
fused_xcorr_bucket`` (Pallas, TPU) to a CUDA C++ kernel for Hopper,
``csrc/fused_xcorr.cu``.  For every band row g of one window-length bucket,
window w and element pair p = (i, j)::

    win     = the window starting at min(w * hop[g], maxstart[g]),
              masked by len_mask[g] and demeaned over its valid samples
    F       = win @ [Cf | -Sf]                 (forward DFT)
    CS      = F_j * conj(F_i)                  (cross-spectrum)
    cc      = Re CS @ Ec - Im CS @ Es          (inverse DFT at the lags)
    idx     = the first lag in [lo[g], hi[g]] reaching max cc
    rho     = max cc / sqrt(E_i * E_j)

The windows, cross-spectra and correlation never reach device memory on the
card.  A CUDA tensor always goes to the kernel; a CPU tensor goes to
``fused_xcorr_bucket_reference``, the plain PyTorch version, which the tests
hold against the JAX kernel and the card holds the CUDA kernel against.
The kernel computes in fp32 whatever matmul precision the caller names.

Where the TPU kernel selects the pairs' spectra with block-diagonal one-hot
matmuls (``sbi``/``sbj``, a Mosaic workaround), the port reads them by
index from ``pairs``, so its tables are only Cf/Sf/Ec/Es.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import numpy as np
import torch

from narrow_band_least_squares_tpu_torch.utils.device import fp32_matmul

# Launches of the CUDA kernel since the count was last set to 0.
launches = 0

_bound = None


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def precompute_fused_tables(
    Lg: int,
    pairs: np.ndarray,       # (P, 2) int
    nchans: int,
    max_lag: int | None = None,
    Kt: int = 128,
) -> Dict[str, object]:
    """Host-side tables for `fused_xcorr_bucket` (one bucket, length Lg).

    The DFT tables of `precompute_dft_tables` (nfft = 2*Lg, lags
    [-half, half]) with K zero-padded to a multiple of ``Kt`` and the lags
    to a multiple of 128, as in the JAX package: the extra k columns are
    zero in every table and add nothing, the extra lags lie outside every
    band's [lo, hi].  ``pairs`` must index the ``nchans`` channels.
    """
    from narrow_band_least_squares_tpu_torch.ops.xcorr import precompute_dft_tables

    pairs = np.asarray(pairs)
    if pairs.ndim != 2 or pairs.shape[1] != 2 or pairs.min() < 0 \
            or pairs.max() >= nchans:
        raise ValueError(f"pairs must be (P, 2) indices below {nchans}")
    tab = precompute_dft_tables(Lg, dtype=np.float32, max_lag=max_lag)
    Cf, Sf, Ec, Es = tab["Cf"], tab["Sf"], tab["Ec"], tab["Es"]
    K, nlag = Cf.shape[1], Ec.shape[1]
    Kp, nlagp = _round_up(K, Kt), _round_up(nlag, 128)
    return {
        "Cf": np.pad(Cf, ((0, 0), (0, Kp - K))),
        "Sf": np.pad(Sf, ((0, 0), (0, Kp - K))),
        "Ec": np.pad(Ec, ((0, Kp - K), (0, nlagp - nlag))),
        "Es": np.pad(Es, ((0, Kp - K), (0, nlagp - nlag))),
        "lag_min": tab["lag_min"], "nlag": nlag, "K": K,
    }


def fused_correlation(
    y: torch.Tensor,          # (Bg, C, T) filtered band rows
    hop: torch.Tensor,        # (Bg, 1) int32
    maxstart: torch.Tensor,   # (Bg, 1) int32
    len_mask: torch.Tensor,   # (Bg, Lg)
    Cf: torch.Tensor,         # (Lg, Kp)
    Sf: torch.Tensor,
    Ec: torch.Tensor,         # (Kp, nlagp)
    Es: torch.Tensor,
    pairs: torch.Tensor,      # (P, 2) int
    Wmax: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version's correlation, step by step in the inputs' dtype.

    Returns ``cc (Bg, Wmax, P, nlagp)`` and ``denom = sqrt(E_i * E_j)
    (Bg, Wmax, P)``.
    """
    Bg, C, T = y.shape
    Lg = len_mask.shape[1]
    dev = y.device
    w = torch.arange(Wmax, device=dev)
    start = torch.minimum(w[None, :] * hop.long(), maxstart.long())  # (Bg, W)
    t = start[:, :, None] + torch.arange(Lg, device=dev)              # (Bg, W, Lg)
    inside = t < T
    raw = torch.gather(
        y[:, None, :, :].expand(Bg, Wmax, C, T), 3,
        t.clamp(max=T - 1)[:, :, None, :].expand(Bg, Wmax, C, Lg),
    )
    raw = torch.where(inside[:, :, None, :], raw, torch.zeros((), dtype=y.dtype, device=dev))
    lm = len_mask[:, None, None, :]
    raw = raw * lm
    mean = raw.sum(-1, keepdim=True) / len_mask.sum(-1)[:, None, None, None]
    win = (raw - mean) * lm                                            # (Bg, W, C, Lg)
    energy = (win * win).sum(-1)                                       # (Bg, W, C)
    with fp32_matmul():
        ReF = win @ Cf
        ImF = -(win @ Sf)
    i, j = pairs[:, 0].long(), pairs[:, 1].long()
    ReI, ImI, ReJ, ImJ = ReF[:, :, i], ImF[:, :, i], ReF[:, :, j], ImF[:, :, j]
    ReCS = ReJ * ReI + ImJ * ImI
    ImCS = ImJ * ReI - ReJ * ImI
    with fp32_matmul():
        cc = ReCS @ Ec - ImCS @ Es                                     # (Bg, W, P, nlagp)
    denom = torch.sqrt(energy[:, :, i] * energy[:, :, j])
    return cc, denom


def fused_xcorr_bucket_reference(
    y, hop, maxstart, lo, hi, len_mask, Cf, Sf, Ec, Es, pairs, Wmax: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: `fused_correlation`, then the masked first maximum
    over each band's [lo, hi] and ``rho = where(denom > 0, peak/denom, 0)``.
    Returns ``(rho (Bg, Wmax, P), idx (Bg, Wmax, P) int32)``."""
    cc, denom = fused_correlation(y, hop, maxstart, len_mask, Cf, Sf, Ec, Es,
                                  pairs, Wmax)
    col = torch.arange(cc.shape[-1], device=cc.device, dtype=torch.int32)
    valid = (col >= lo[:, :, None, None]) & (col <= hi[:, :, None, None])
    ccm = torch.where(valid, cc, torch.tensor(-torch.inf, dtype=cc.dtype,
                                              device=cc.device))
    peak = ccm.amax(dim=-1)
    first = torch.where(ccm == peak[..., None], col, torch.iinfo(torch.int32).max)
    idx = first.amin(dim=-1)
    idx = torch.where(torch.isneginf(peak), torch.zeros_like(idx), idx)
    rho = torch.where(denom > 0, peak / denom, torch.zeros_like(peak))
    return rho, idx


def _check(y, hop, maxstart, lo, hi, len_mask, Cf, Sf, Ec, Es, pairs, Wmax):
    if y.dim() != 3:
        raise ValueError(f"fused_xcorr_bucket needs y (Bg, C, T); got {tuple(y.shape)}")
    Bg, C, T = y.shape
    for name, t in (("hop", hop), ("maxstart", maxstart), ("lo", lo), ("hi", hi)):
        if tuple(t.shape) != (Bg, 1):
            raise ValueError(f"fused_xcorr_bucket needs {name} of shape ({Bg}, 1); "
                             f"got {tuple(t.shape)}")
        if t.dtype != torch.int32:
            raise TypeError(f"fused_xcorr_bucket needs int32 {name}; got {t.dtype}")
    if len_mask.dim() != 2 or len_mask.shape[0] != Bg:
        raise ValueError(f"fused_xcorr_bucket needs len_mask ({Bg}, Lg); "
                         f"got {tuple(len_mask.shape)}")
    Lg = len_mask.shape[1]
    if Cf.dim() != 2 or Cf.shape[0] != Lg or Sf.shape != Cf.shape:
        raise ValueError(f"fused_xcorr_bucket needs Cf and Sf ({Lg}, Kp); got "
                         f"{tuple(Cf.shape)} and {tuple(Sf.shape)}")
    Kp = Cf.shape[1]
    if Ec.dim() != 2 or Ec.shape[0] != Kp or Es.shape != Ec.shape:
        raise ValueError(f"fused_xcorr_bucket needs Ec and Es ({Kp}, nlag); got "
                         f"{tuple(Ec.shape)} and {tuple(Es.shape)}")
    if pairs.dim() != 2 or pairs.shape[1] != 2 or pairs.shape[0] == 0:
        raise ValueError(f"fused_xcorr_bucket needs pairs (P, 2); got {tuple(pairs.shape)}")
    if pairs.dtype != torch.int32:
        raise TypeError(f"fused_xcorr_bucket needs int32 pairs; got {pairs.dtype}")
    for name, t in (("y", y), ("len_mask", len_mask), ("Cf", Cf), ("Sf", Sf),
                    ("Ec", Ec), ("Es", Es)):
        if t.dtype != torch.float32:
            raise TypeError(f"fused_xcorr_bucket needs float32 {name}; got {t.dtype}")
    if int(Wmax) < 1 or min(C, T, Lg, Kp, Ec.shape[1]) < 1:
        raise ValueError(f"fused_xcorr_bucket needs non-empty shapes; got y "
                         f"{tuple(y.shape)}, Lg {Lg}, Kp {Kp}, nlag {Ec.shape[1]}, "
                         f"Wmax {Wmax}")
    devs = {t.device for t in (y, hop, maxstart, lo, hi, len_mask, Cf, Sf,
                               Ec, Es, pairs)}
    if len(devs) != 1:
        raise ValueError(f"fused_xcorr_bucket inputs lie on several devices: {devs}")


def _lib():
    global _bound
    if _bound is None:
        from narrow_band_least_squares_tpu_torch.ops.kernels._build import load_library

        lib = load_library("fused_xcorr")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.nbls_fused_xcorr_f32.argtypes = [p] * 18 + [i] * 8 + [p]
        lib.nbls_fused_xcorr_f32.restype = ctypes.c_int
        for fn, args in ((lib.nbls_fused_xcorr_lag_tile, []),
                         (lib.nbls_fused_xcorr_split, []),
                         (lib.nbls_fused_xcorr_fits, [i, i])):
            fn.argtypes, fn.restype = args, ctypes.c_int
        _bound = lib
    return _bound


def fused_xcorr_bucket(
    y: torch.Tensor,          # (Bg, C, T) float32 filtered band rows
    hop: torch.Tensor,        # (Bg, 1) int32 hop per band [samples]
    maxstart: torch.Tensor,   # (Bg, 1) int32 the band's last window start (T - Lb)
    lo: torch.Tensor,         # (Bg, 1) int32 first valid lag index per band
    hi: torch.Tensor,         # (Bg, 1) int32 last valid lag index per band
    len_mask: torch.Tensor,   # (Bg, Lg) float32 valid samples per band
    Cf: torch.Tensor,         # (Lg, Kp) float32 forward cos table
    Sf: torch.Tensor,         # (Lg, Kp) float32 forward sin table
    Ec: torch.Tensor,         # (Kp, nlag) float32 inverse cos table
    Es: torch.Tensor,         # (Kp, nlag) float32 inverse sin table
    pairs: torch.Tensor,      # (P, 2) int32 element pairs (i, j)
    Wmax: int,                # windows per band row
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Delays of one window-length bucket.  Returns ``(rho (Bg, Wmax, P)
    float32, idx (Bg, Wmax, P) int32)``; ``idx`` indexes the lag columns of
    Ec/Es (``tau = (idx + lag_min) / fs``)."""
    global launches
    _check(y, hop, maxstart, lo, hi, len_mask, Cf, Sf, Ec, Es, pairs, Wmax)
    dev = y.device
    if dev.type == "cpu":
        return fused_xcorr_bucket_reference(y, hop, maxstart, lo, hi, len_mask,
                                            Cf, Sf, Ec, Es, pairs, Wmax)
    if dev.type != "cuda":
        raise ValueError(f"fused_xcorr_bucket runs on cuda or cpu tensors, not {dev}")
    args = (y, hop, maxstart, lo, hi, len_mask, Cf, Sf, Ec, Es, pairs)
    names = ("y", "hop", "maxstart", "lo", "hi", "len_mask", "Cf", "Sf", "Ec",
             "Es", "pairs")
    for name, t in zip(names, args):
        if not t.is_contiguous():
            raise ValueError(f"fused_xcorr_bucket needs a contiguous {name}")
    Bg, C, T = y.shape
    Lg, (Kp, nlag), P, W = len_mask.shape[1], Ec.shape, pairs.shape[0], int(Wmax)
    lib = _lib()
    ntiles = -(-nlag // lib.nbls_fused_xcorr_lag_tile())
    split = lib.nbls_fused_xcorr_split()
    for what, n in (("Bg*C*T", Bg * C * T),
                    ("split*Bg*Wmax*C*2*Kp", split * Bg * W * C * 2 * Kp),
                    ("lag tiles*Bg*Wmax*P", ntiles * Bg * W * P)):
        if n >= 2**31:
            raise ValueError(f"fused_xcorr_bucket: {what} = {n} needs 64-bit offsets "
                             f"(y {tuple(y.shape)}, Wmax {W}, Kp {Kp}, nlag {nlag}, P {P})")
    if not lib.nbls_fused_xcorr_fits(C, P):
        raise ValueError(f"fused_xcorr_bucket: the spectra of {C} elements ({P} pairs) "
                         f"do not fit a block's shared memory")
    f32 = dict(dtype=torch.float32, device=dev)
    rho = torch.empty((Bg, W, P), **f32)
    idx = torch.empty((Bg, W, P), dtype=torch.int32, device=dev)
    mean = torch.empty((Bg * W * C,), **f32)
    energy = torch.empty((Bg * W * C,), **f32)
    spec = torch.empty((split, Bg * W * C, 2 * Kp), **f32)
    part_val = torch.empty((ntiles, Bg * W * P), **f32)
    part_idx = torch.empty((ntiles, Bg * W * P), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.nbls_fused_xcorr_f32(
            *(t.data_ptr() for t in args),
            rho.data_ptr(), idx.data_ptr(), mean.data_ptr(), energy.data_ptr(),
            spec.data_ptr(), part_val.data_ptr(), part_idx.data_ptr(),
            Bg, C, T, Lg, W, Kp, nlag, P, stream,
        )
    if err != 0:
        raise RuntimeError(f"fused_xcorr_bucket kernel launch failed: CUDA error {err}")
    launches += 1
    return rho, idx
