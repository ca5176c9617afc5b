"""Batched inter-element delay estimation: DFT-as-matmul and FFT
cross-correlation.

Port of ``narrow_band_least_squares_tpu/ops/xcorr.py``.  Every
(band, window, element-pair) cell is one row of a batched computation:

    spectra:      F  = win @ [Cf | Sf]                 (torch.matmul, fp32)
    cross-spec:   CS = F_j * conj(F_i)
    correlation:  cc = [Re CS | Im CS] @ [Ec ; -Es]    (icorr_peak)
    delay:        tau = (first argmax over the band's lags + lag_min) * (1/fs)
    rho = peak / sqrt(E_i * E_j),  MdCCM = median over pairs of rho

The last two lines of the chain run in the ``icorr_peak`` kernel, which
never writes the (rows, lags) correlation out, at the pipeline's
``matmul_precision`` (fp32, 3xTF32 or 1xTF32 on the card; see
`ops.kernels.xcorr_peak`).  The forward-DFT products of ``_cross_spectra``
stay IEEE fp32 (cuBLAS) at every precision; `ops.kernels.pair_spectra`
forms the cross-spectra from them at ``e2``'s padded width.  Conventions
are those of the reference: ``cc_p(l) = sum_t x_j(t + l) x_i(t)``, lags
ascending, the first maximum wins.  Tables are built in float64 on the
host and cast to float32.

A table set (a window-length bucket's, or the unbucketed grid's) is built
once: on the host by `band_tables` (or `precompute_pallas_tables`), with the
band limit applied there, and on the device by `lag_tables`, which also
turns each band's lag mask into its lag columns ``[lo, hi]``.  Every lag
search of the 'mxu' and 'pallas' routes, band-sharded or not, is then one
`cross_correlate_bounds` call on that form.

`cross_correlate` is the FFT form (``xcorr_method='fft'``): ``torch.fft``
at ``nfft``, the circular lags reordered into linear ones, the masked
first maximum over every lag; the JAX package computes it outside any
Pallas kernel too.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as Fnn

from narrow_band_least_squares_tpu_torch.ops.kernels.pair_spectra import pair_spectra
from narrow_band_least_squares_tpu_torch.ops.kernels.xcorr_peak import icorr_peak, prepare
from narrow_band_least_squares_tpu_torch.utils.device import fp32_matmul
from narrow_band_least_squares_tpu_torch.utils.profiling import span


def cross_correlate(
    win: torch.Tensor,       # (B, W, C, Lmax) demeaned, zero-padded windows
    pairs: torch.Tensor,     # (P, 2) int64
    lag_mask: torch.Tensor,  # (B, 2*Lmax-1) bool
    nfft: int,               # >= 2*Lmax
    fs: float,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """FFT cross-correlation.  Returns (tau (B, W, P) [s], rho (B, W, P),
    mdccm (B, W)).  Delays are `lag_seconds` of the first maximum."""
    B, W, C, Lmax = win.shape
    energy = torch.sum(win * win, dim=-1)                 # (B, W, C)
    Wf = torch.fft.rfft(win, n=nfft, dim=-1)              # (B, W, C, F)
    Fi = Wf[:, :, pairs[:, 0], :]
    Fj = Wf[:, :, pairs[:, 1], :]
    cc = torch.fft.irfft(Fj * torch.conj(Fi), n=nfft, dim=-1)   # circular lags
    # circular -> linear 'full' order: [-(Lmax-1) .. Lmax-1]
    cc_lin = torch.cat([cc[..., nfft - (Lmax - 1):], cc[..., :Lmax]], dim=-1)
    neg_inf = torch.full((), float("-inf"), dtype=cc.dtype, device=cc.device)
    cc_masked = torch.where(lag_mask[:, None, None, :], cc_lin, neg_inf)
    k = torch.argmax(cc_masked, dim=-1)                   # the first maximum
    peak = torch.gather(cc_masked, -1, k[..., None])[..., 0]
    tau = lag_seconds(k.to(win.dtype) - (Lmax - 1), fs)
    Ei = energy[:, :, pairs[:, 0]]
    Ej = energy[:, :, pairs[:, 1]]
    denom = torch.sqrt(Ei * Ej)
    rho = torch.where(denom > 0, peak / denom, torch.zeros_like(peak))
    return tau, rho, median_last(rho)


def band_limit_auto_db(bt_min: float) -> float:
    """BT-aware band-limit threshold (band_limit_db='auto').

    Neighbouring correlation lobes differ by ~1/(2BT), so the tolerable cc
    error, and with it the bin-truncation level, scales with the band's
    time-bandwidth product: ``db = 40 + 95*log10(4.6/BT)``, clipped to
    [40, 90] (the JAX package's calibration, kept so both give one result).
    """
    if bt_min >= 4.6:
        return 40.0
    return float(min(90.0, 40.0 + 95.0 * math.log10(4.6 / max(bt_min, 0.05))))


def band_limit_bins(
    sos_list, band_idx, nfft: int, fs: float, limit_db: float,
    zerophase: bool = False,
) -> Tuple[int, int]:
    """Contiguous DFT-bin range covering the bands' filter passbands.

    Returns (kmin, kmax) such that every bin where ANY of the bands'
    magnitude responses exceeds ``-limit_db`` dB of the group peak is inside
    the range.  The DFT-as-matmul form then only needs those table rows.
    """
    from scipy import signal as _sig

    K = nfft // 2 + 1
    freqs = np.arange(K) * fs / nfft
    mag = np.zeros(K)
    for b in band_idx:
        _, h = _sig.sosfreqz(sos_list[int(b)], worN=freqs, fs=fs)
        m = np.abs(h)
        if zerophase:
            m = m * m
        mag = np.maximum(mag, m)
    thresh = mag.max() * 10.0 ** (-float(limit_db) / 20.0)
    keep = np.flatnonzero(mag >= thresh)
    if len(keep) == 0:
        return 0, K - 1
    return int(keep[0]), int(keep[-1])


def slice_tables_bins(tab: Dict[str, np.ndarray], kmin: int, kmax: int
                      ) -> Dict[str, np.ndarray]:
    """Restrict DFT matmul tables to bin rows [kmin, kmax]."""
    K = tab["Cf"].shape[1]
    kmax = min(kmax, K - 1)
    sl = slice(kmin, kmax + 1)
    out = dict(tab)
    out["Cf"] = tab["Cf"][:, sl]
    out["Sf"] = tab["Sf"][:, sl]
    out["Ec"] = tab["Ec"][sl]
    out["Es"] = tab["Es"][sl]
    return out


def precompute_dft_tables(Lmax: int, dtype=np.float32,
                          nfft: int | None = None,
                          max_lag: int | None = None) -> Dict[str, np.ndarray]:
    """DFT matmul tables.  ``max_lag`` restricts the evaluated lag range to
    ``[-max_lag, max_lag]``."""
    n = int(nfft) if nfft else 2 * Lmax  # >= 2*Lmax - 1
    K = n // 2 + 1
    t = np.arange(Lmax)[:, None]                    # (L, 1)
    k = np.arange(K)[None, :]                       # (1, K)
    ang_f = 2.0 * np.pi * t * k / n
    Cf = np.cos(ang_f)
    Sf = np.sin(ang_f)

    half = Lmax - 1 if max_lag is None else min(int(max_lag), Lmax - 1)
    lags = np.arange(-half, half + 1)               # ascending, 'full' order
    m = np.mod(lags, n)[None, :]                    # (1, nlag)
    w = np.full((K, 1), 2.0)
    w[0, 0] = 1.0
    if n % 2 == 0:
        w[-1, 0] = 1.0
    ang_i = 2.0 * np.pi * np.arange(K)[:, None] * m / n
    Ec = (w / n) * np.cos(ang_i)
    Es = (w / n) * np.sin(ang_i)
    return {
        "Cf": Cf.astype(dtype), "Sf": Sf.astype(dtype),
        "Ec": Ec.astype(dtype), "Es": Es.astype(dtype),
        "nfft": n, "lag_min": int(lags[0]),
    }


def band_tables(Lg: int, max_lag: int | None, band_idx: Sequence[int], plan,
                sos_list, band_limit_db, zerophase: bool) -> Dict[str, np.ndarray]:
    """The host DFT tables of one table set: `precompute_dft_tables` at
    ``(Lg, max_lag)`` for the bands ``band_idx`` of ``plan``.  With
    ``band_limit_db`` (dB, or ``'auto'``: `band_limit_auto_db` of the
    bands' lowest BT) they keep only the bins of `band_limit_bins` over
    the bands' filters ``sos_list``."""
    tab = precompute_dft_tables(Lg, np.float32, max_lag=max_lag)
    if not band_limit_db:
        return tab
    if band_limit_db == "auto":
        bts = plan.bt_products()
        db = band_limit_auto_db(min(bts[int(b)] for b in band_idx))
    else:
        db = float(band_limit_db)
    kmin, kmax = band_limit_bins(sos_list, band_idx, tab["nfft"], plan.fs, db,
                                 zerophase=zerophase)
    return slice_tables_bins(tab, kmin, kmax)


def _round_up_128(x: int) -> int:
    return ((x + 127) // 128) * 128


def stack_inverse_table(Ec: np.ndarray | torch.Tensor,
                        Es: np.ndarray | torch.Tensor):
    """``e2 = [Ec ; -Es]`` with rows zero-padded to a multiple of 128: the
    inverse-DFT operand of ``icorr_peak``."""
    K, nlag = Ec.shape
    K2p = _round_up_128(2 * K)
    if isinstance(Ec, torch.Tensor):
        e2 = torch.cat([Ec, -Es], dim=0)
        return Fnn.pad(e2, (0, 0, 0, K2p - 2 * K)).contiguous()
    e2 = np.zeros((K2p, nlag), dtype=Ec.dtype)
    e2[:K] = Ec
    e2[K:2 * K] = -Es
    return e2


def precompute_pallas_tables(
    Lmax: int, band_lengths: np.ndarray, dtype=np.float32,
    max_lag: int | None = None,
) -> Dict[str, np.ndarray]:
    """Stacked/padded DFT tables + per-band lag bounds for ``icorr_peak``.

    ``max_lag`` caps the evaluated lag range to ``[-max_lag, max_lag]``,
    exactly like `precompute_dft_tables`."""
    half = Lmax - 1 if max_lag is None else min(int(max_lag), Lmax - 1)
    tab = precompute_dft_tables(Lmax, dtype, max_lag=half)
    K = tab["Cf"].shape[1]
    e2 = stack_inverse_table(tab["Ec"], tab["Es"])
    bh = np.minimum(np.asarray(band_lengths) - 1, half)            # (B,)
    lo = (half - bh).astype(np.int32)
    hi = (half + bh).astype(np.int32)
    return {
        "Cf": tab["Cf"], "Sf": tab["Sf"], "e2": e2,
        "K": K, "K2p": e2.shape[0], "nlag": 2 * half + 1, "lag_min": -half,
        "lo": lo, "hi": hi,
    }


def lag_bounds(lag_mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each band's first and last True lag column, int32: a band's
    ``lag_mask`` row is the one contiguous run ``[half - bh, half + bh]``."""
    nlag = lag_mask.shape[-1]
    m = lag_mask.to(torch.int32)
    lo = m.argmax(dim=-1).to(torch.int32)
    hi = (nlag - 1 - m.flip(-1).argmax(dim=-1)).to(torch.int32)
    return lo, hi


def lag_tables(s: Mapping, device, precision: str = "highest",
               dtype=torch.float32) -> Dict:
    """The device form of one table set, built once, which
    `cross_correlate_bounds` reads: ``Cf``, ``Sf``, the inverse operand
    ``e2``, each band's lag columns ``lo``/``hi`` (int32), ``lag_min`` and
    ``prepared``, ``e2``'s operand for the card route of ``precision``
    (`xcorr_peak.prepare`; None off the card).

    ``s`` holds state-named tensors or arrays: ``Cf`` and ``Sf``; ``e2``,
    or ``Ec`` and ``Es`` (stacked here); ``lo`` and ``hi``, or ``lag_mask``
    (`lag_bounds`, here).  The lags are ``[-half, half]``, so ``lag_min``
    is ``-half``.  A narrow ``dtype`` rounds the tables to its values, where
    the JAX step holds them in it; they stay float32."""
    dev = torch.device(device)
    get = lambda k: torch.as_tensor(s[k]).to(dev)
    e2 = get("e2") if "e2" in s else stack_inverse_table(get("Ec"), get("Es"))
    lo, hi = (get("lo"), get("hi")) if "lo" in s else lag_bounds(get("lag_mask"))
    rnd = lambda t: t.to(dtype).to(t.dtype)
    out = {"Cf": rnd(get("Cf")), "Sf": rnd(get("Sf")), "e2": rnd(e2),
           "lo": lo.to(torch.int32), "hi": hi.to(torch.int32),
           "lag_min": -(e2.shape[1] // 2), "prepared": None}
    if dev.type == "cuda":
        out["prepared"] = prepare(out["e2"], precision)
    return out


def median_last(x: torch.Tensor) -> torch.Tensor:
    """Median over the last axis, the mean of the two middle values for an
    even count (``jnp.median``; ``torch.median`` returns the lower one)."""
    n = x.shape[-1]
    s = torch.sort(x, dim=-1).values
    return (s[..., (n - 1) // 2] + s[..., n // 2]) * 0.5


def _cross_spectra(win, pairs, Cf, Sf, width):
    """Energies (B, W, C) in the windows' dtype and stacked cross-spectra
    (B*W*P, ``width``), `pair_spectra`'s ``cs2``; the spectra matmuls are
    IEEE fp32 (on narrower windows, their exact float32 values) whatever
    ``matmul_precision`` says."""
    with span("nbls.spectra"):
        B, W, C, Lmax = win.shape
        energy = torch.sum(win * win, dim=-1)
        flat = win.reshape(B * W * C, Lmax).to(Cf.dtype)
        with fp32_matmul():
            ReF = torch.matmul(flat, Cf).reshape(B * W, C, -1)
            S = torch.matmul(flat, Sf).reshape(B * W, C, -1)   # ImF = -S
        return energy, pair_spectra(ReF, S, pairs, width)


def lag_seconds(lag: torch.Tensor, fs: float) -> torch.Tensor:
    """Lags (float tensor, samples) -> delays in seconds, as
    ``lag * (1/fs)`` with the reciprocal rounded to float32 and the product
    to the tensor's dtype.

    PyTorch on CUDA divides by a host scalar by multiplying with its
    reciprocal and on the CPU divides, so ``lag / fs`` differs in the last
    bit between the two; the jitted JAX step multiplies too.  The LTS flags
    depend on those bits, so every device computes this product, in
    float32: for a narrower dtype, CUDA would round the reciprocal itself
    to that dtype and the CPU would not.
    """
    return (lag.float() * (1.0 / fs)).to(lag.dtype)


def add_lag(lag: torch.Tensor, offset: int) -> torch.Tensor:
    """``lag + offset`` in ``lag``'s dtype, the offset rounded to it first
    (what the JAX package's weakly typed integer does) and the sum in
    float32, on every device."""
    off = torch.tensor(offset, dtype=lag.dtype).float().item()
    return (lag.float() + off).to(lag.dtype)


def subsample_frac(peak, cm, cp, idx, nlag: int) -> torch.Tensor:
    """The three-point parabola's vertex offset from the integer peak:
    ``0.5 (cm - cp) / (cm - 2 peak + cp)`` where the denominator's magnitude
    exceeds 1e-20 and ``0 < idx < nlag - 1`` (``nlag``: the table's lag
    count), else 0; clipped to [-0.5, 0.5] (the JAX package's rule)."""
    denom = cm - 2.0 * peak + cp
    ok = (denom.abs() > 1e-20) & (idx > 0) & (idx < nlag - 1)
    safe = torch.where(ok, denom, torch.ones_like(denom))
    frac = torch.where(ok, 0.5 * (cm - cp) / safe, torch.zeros_like(denom))
    return frac.clamp(-0.5, 0.5)


def _peak_search(win, pairs, energy, cs2, e2, lo_b, hi_b, lag_min, fs,
                 precision="highest", prepared=None, subsample=False):
    """``icorr_peak`` over every (band, window, pair) row at ``precision``
    (``prepared``: e2's operand for the card, `xcorr_peak.prepare`), then
    tau/rho/MdCCM.  ``subsample`` takes the peak's neighbours from the
    kernel and refines each delay by `subsample_frac`."""
    B, W = win.shape[:2]
    P = pairs.shape[0]
    lo = lo_b[:, None].expand(B, W * P).reshape(-1).contiguous()
    hi = hi_b[:, None].expand(B, W * P).reshape(-1).contiguous()
    with span("nbls.lag_search"):
        found = icorr_peak(cs2, e2, lo, hi, precision=precision, prepared=prepared,
                           neighbours=subsample)
    peak, idx = found[0], found[1]
    lag = idx.to(win.dtype)
    if subsample:   # a float32 frac promotes a narrower lag, as in JAX
        lag = lag + subsample_frac(peak, found[2], found[3], idx, e2.shape[1])
    tau = lag_seconds(add_lag(lag.reshape(B, W, P), lag_min), fs)
    peak = peak.reshape(B, W, P)
    Ei = energy[:, :, pairs[:, 0]]
    Ej = energy[:, :, pairs[:, 1]]
    denom = torch.sqrt(Ei * Ej).to(peak.dtype)
    rho = torch.where(denom > 0, peak / denom, torch.zeros_like(peak))
    return tau, rho, median_last(rho)


def cross_correlate_mxu(
    win: torch.Tensor,       # (B, W, C, Lmax) demeaned, zero-padded windows
    pairs: torch.Tensor,     # (P, 2) int64
    lag_mask: torch.Tensor,  # (B, nlag) bool, one contiguous run per band
    tables: Dict,            # precompute_dft_tables (tensors), "e2" optional
    fs: float,
    subsample: bool = False,
    lag_tile: int = 512,
    precision: str = "highest",
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """DFT-as-matmul cross-correlation on each band's ``lag_mask``, the
    JAX package's operation: `cross_correlate_bounds` on the mask's
    `lag_bounds`.  ``lag_tile`` is accepted for signature parity and
    changes nothing: the kernel never forms the (rows, lags) correlation
    that the JAX path tiles.  A pipeline turns its masks into bounds once
    (`lag_tables`), not on each call."""
    del lag_tile
    lo, hi = lag_bounds(lag_mask)
    return cross_correlate_bounds(win, pairs, lo, hi, tables, fs, precision,
                                  subsample)


def cross_correlate_bounds(
    win: torch.Tensor,       # (B, W, C, Lmax)
    pairs: torch.Tensor,     # (P, 2) int64
    lo: torch.Tensor,        # (B,) int32: first lag column of each band
    hi: torch.Tensor,        # (B,) int32: last lag column of each band
    tables: Dict,            # lag_tables, or precompute_dft_tables (tensors)
    fs: float,
    precision: str = "highest",
    subsample: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """DFT-as-matmul cross-correlation over each band's lag columns
    ``[lo, hi]``.  Returns (tau, rho, mdccm).

    The integer-lag search is ``icorr_peak`` at ``precision`` on
    ``tables["e2"]`` (`stack_inverse_table`), built from Ec/Es when absent;
    ``tables["prepared"]``, its operand for the card (`xcorr_peak.prepare`
    at ``precision``), is needed on the card.  ``subsample=True`` refines
    each integer-lag peak with the parabola through it and its two
    neighbouring correlations (`subsample_frac`), which the kernel returns
    beside the peak."""
    e2 = tables.get("e2")
    if e2 is None:
        e2 = stack_inverse_table(tables["Ec"], tables["Es"])
    energy, cs2 = _cross_spectra(win, pairs, tables["Cf"], tables["Sf"], e2.shape[0])
    lag_min = tables.get("lag_min", -(win.shape[-1] - 1))
    return _peak_search(win, pairs, energy, cs2, e2, lo, hi, lag_min, fs,
                        precision, tables.get("prepared"), subsample)


def cross_correlate_pallas(
    win: torch.Tensor,       # (B, W, C, Lmax)
    pairs: torch.Tensor,     # (P, 2)
    tables: Dict,            # precompute_pallas_tables (tensors)
    fs: float,
    precision: str = "highest",
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Cross-correlation on the stacked tables of `precompute_pallas_tables`
    and their bounds ``lo``/``hi``, the JAX package's operation:
    `cross_correlate_bounds`."""
    return cross_correlate_bounds(win, pairs, tables["lo"], tables["hi"], tables, fs,
                                  precision)
