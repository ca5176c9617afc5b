"""Reference-parity public API.

Port of ``narrow_band_least_squares_tpu/api.py``: the reference's functions
with the reference's call signatures and tuple contracts, as a thin host
shim over `models.NarrowBandPipeline`.  Every function that computes takes a
keyword-only ``device``: ``None`` means ``"cuda"`` and raises where CUDA is
absent; ``"cpu"`` runs the kernels' plain PyTorch versions.  ``ALPHA = 1``
is OLS; ``ALPHA < 1`` is exact-enumeration LTS and returns the reference's
``stdict`` of flagged elements.
"""

from __future__ import annotations

import functools
from typing import Sequence, Tuple

import numpy as np
import torch

from narrow_band_least_squares_tpu_torch.io.stream import ArrayStream
from narrow_band_least_squares_tpu_torch.io.textio import read_txtfile, write_txtfile
from narrow_band_least_squares_tpu_torch.models.narrowband import (
    NarrowBandPipeline,
    flags_to_stdict,
)
from narrow_band_least_squares_tpu_torch.ops import filters as _filters
from narrow_band_least_squares_tpu_torch.ops.solve import (
    chi2_ellipse_uncertainties,
    subset_normal_inverses,
)
from narrow_band_least_squares_tpu_torch.utils.device import resolve_device
from narrow_band_least_squares_tpu_torch.utils.geometry import get_rij
from narrow_band_least_squares_tpu_torch.utils.plan import (
    band_edges,
    get_freqlist,
    get_winlenlist,
    make_plan,
)
from narrow_band_least_squares_tpu_torch.utils.profiling import span

__all__ = [
    "get_freqlist",
    "get_winlenlist",
    "get_rij",
    "make_float",
    "filter_data",
    "write_txtfile",
    "read_txtfile",
    "ltsva",
    "narrow_band_least_squares",
    "narrow_band_least_squares_parallel",
    "narrow_band_loop",
    "set_performance_defaults",
    "PRODUCTION_DEFAULTS",
]

# Pipeline overrides applied to every pipeline this surface constructs.
_PERF_DEFAULTS: dict = {}

# The JAX package's production profile: passband-only cross-correlation
# bins at a BT-aware threshold, and with ``ALPHA < 1`` the FAST-LTS funnel
# (max(16, ceil(Q/24)) survivors after one C-step).
PRODUCTION_DEFAULTS = {
    "band_limit_db": "auto",
    "lts_funnel_k": "auto",
}


def set_performance_defaults(**kwargs) -> dict:
    """Set pipeline options for every pipeline the parity API constructs.

    Any `models.NarrowBandPipeline` keyword (``xcorr_method``,
    ``max_lag_s``, ``band_limit_db``, ...).  ``None`` removes a key.
    Returns the previous overrides, so callers can restore them.
    """
    prev = dict(_PERF_DEFAULTS)
    for k, v in kwargs.items():
        if v is None:
            _PERF_DEFAULTS.pop(k, None)
        else:
            _PERF_DEFAULTS[k] = v
    _cached_pipeline.cache_clear()
    return prev


@functools.lru_cache(maxsize=32)
def _cached_pipeline(plan, rij_key, filter_type, filter_order, filter_ripple,
                     alpha, apply_filter, perf_key, device):
    with span("nbls.pipeline.build"):     # a cache miss only
        rij = np.asarray(rij_key, dtype=np.float64)
        return NarrowBandPipeline(
            plan, rij,
            filter_type=filter_type, filter_order=filter_order,
            filter_ripple=filter_ripple, alpha=alpha, apply_filter=apply_filter,
            device=device, **dict(perf_key),
        )


def _get_pipeline(plan, rij, filter_type="cheby1", filter_order=2,
                  filter_ripple=0.01, alpha=1.0, apply_filter=True,
                  device=None):
    """Memoize pipelines (and their device constants) across API calls."""
    rij_key = tuple(tuple(float(v) for v in row) for row in rij)
    perf_key = tuple(sorted(_PERF_DEFAULTS.items()))
    return _cached_pipeline(
        plan, rij_key, filter_type, filter_order, filter_ripple,
        float(alpha), bool(apply_filter), perf_key, str(resolve_device(device)),
    )


def make_float(input) -> np.ndarray:
    """Element-by-element cast to a float ndarray (reference helpers.py:145-158)."""
    return np.array([float(v) for v in input])


def filter_data(
    st: ArrayStream,
    FILTER_TYPE: str,
    FMIN: float,
    FMAX: float,
    FILTER_ORDER: int,
    FILTER_RIPPLE: float,
    *,
    device=None,
) -> Tuple[ArrayStream, float, np.ndarray]:
    """Bandpass + 1% taper; returns (filtered stream, Fs, sos).

    Same contract as reference ``helpers.py:108-141``, including the
    butter-zerophase / cheby1-causal asymmetry, through the exact
    frequency-domain IIR (`ops.filters.filter_bank_fft`) on ``device``.
    """
    dev = resolve_device(device)
    sos = _filters.design_sos(
        FILTER_TYPE, FMIN, FMAX, FILTER_ORDER, FILTER_RIPPLE, st.fs
    )
    L = _filters.impulse_length(sos, st.npts)
    h = _filters.impulse_response(sos, L)
    nfft = _filters.next_pow2(st.npts + L)
    taper = _filters.taper_window(st.npts)
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32)).to(dev)
    y = _filters.filter_bank_fft(
        f32(st.data), f32(h[None, :]), f32(taper), nfft,
        zerophase=(FILTER_TYPE == "butter"),
    )
    stf = st.copy()
    stf.data = y[0].cpu().numpy().astype(np.float64)
    return stf, st.fs, sos


def ltsva(
    st: ArrayStream,
    lat_list: Sequence[float],
    lon_list: Sequence[float],
    WINLEN: float,
    WINOVER: float,
    ALPHA: float = 1.0,
    plot_array_coordinates: bool = False,
    conf: float = None,
    *,
    device=None,
):
    """Least-squares array processing of a pre-filtered stream.

    8-tuple contract of the vendored solver (reference ``example.py:109``):
    ``(vel, baz, t, mdccm, stdict, sig_tau, vel_uncert, baz_uncert)``.
    ``conf=None`` returns the 1-sigma linearized vel/baz uncertainties; a
    confidence level (e.g. ``0.90``) returns the Szuberla & Olson (2004)
    chi-square-ellipse intervals (`ops.solve.chi2_ellipse_uncertainties`),
    with ``ALPHA < 1`` built per window on the retained co-array rows
    (`ops.solve.subset_normal_inverses`).  ``stdict`` is None for OLS and
    the flagged elements per window (no band prefix) for LTS.
    """
    with span("nbls.api"):
        with span("nbls.api.plan"):
            rij = get_rij(list(lat_list), list(lon_list), st.nchans)
            plan = make_plan([0.0, st.fs / 2], "linear", [WINLEN], WINOVER,
                             st.npts, st.fs)
            pipe = _get_pipeline(plan, rij, alpha=ALPHA, apply_filter=False,
                                 device=device)
        res = pipe.run(st)
        n = res.num_compute_list[0]
        vel = res.vel_array[0, :n]
        baz = res.baz_array[0, :n]
        t = res.t_array[0, :n]
        mdccm = res.mdccm_array[0, :n]
        sig_tau = res.sig_tau_array[0, :n]
        vel_uncert = res.vel_uncert_array[0, :n]
        baz_uncert = res.baz_uncert_array[0, :n]
        if conf is not None:
            xtx_inv = pipe.XtX_inv64
            if res.flags is not None:
                xtx_inv = subset_normal_inverses(pipe.X64, ~res.flags[0, :n, :])
            vel_uncert, baz_uncert = chi2_ellipse_uncertainties(
                vel, baz, sig_tau, xtx_inv, conf=conf,
            )
        stdict = None   # OLS flags no element
        if ALPHA < 1.0:
            stdict = flags_to_stdict(
                res.flags, res.t_array, res.num_compute_list, res.pairs,
                st.nchans, band_prefix=False,
            )
        if plot_array_coordinates:  # parity convenience plot, best-effort
            try:
                import matplotlib.pyplot as plt

                fig, ax = plt.subplots()
                try:
                    ax.scatter(rij[0], rij[1])
                    ax.set_xlabel("X [km]")
                    ax.set_ylabel("Y [km]")
                    ax.axis("square")
                    fig.savefig("array_coordinates.png", dpi=150)
                finally:
                    plt.close(fig)
            except Exception:
                pass
        return vel, baz, t, mdccm, stdict, sig_tau, vel_uncert, baz_uncert


def narrow_band_least_squares(
    WINLEN_list: Sequence[float],
    WINOVER: float,
    ALPHA: float,
    st: ArrayStream,
    lat_list: Sequence[float],
    lon_list: Sequence[float],
    NBANDS: int,
    w: np.ndarray,
    h: np.ndarray,
    freqlist: Sequence[float],
    FREQ_BAND_TYPE: str,
    freq_resp_list: np.ndarray,
    FILTER_TYPE: str,
    FILTER_ORDER: int,
    FILTER_RIPPLE: float,
    *,
    device=None,
):
    """Narrow-band least-squares processing (reference tuple contract).

    Returns ``(vel_array, baz_array, mdccm_array, t_array, stdict_all,
    sig_tau_array, num_compute_list, w_array, h_array)`` as at reference
    ``narrow_band_least_squares.py:127``.  ``w``/``h`` are accepted for
    signature parity.
    """
    with span("nbls.api"):
        with span("nbls.api.plan"):
            rij = get_rij(list(lat_list), list(lon_list), st.nchans)
            plan = make_plan(freqlist, FREQ_BAND_TYPE, WINLEN_list, WINOVER,
                             st.npts, st.fs)
            if plan.nbands != NBANDS:
                raise ValueError(
                    f"freqlist implies {plan.nbands} bands but NBANDS={NBANDS}"
                )
            pipe = _get_pipeline(
                plan, rij, filter_type=FILTER_TYPE, filter_order=FILTER_ORDER,
                filter_ripple=FILTER_RIPPLE, alpha=ALPHA, device=device,
            )
        res = pipe.run(st, freq_resp_list=np.asarray(freq_resp_list))
        stdict_all = res.stdict(band_prefix=True) if ALPHA < 1.0 else None
        return (
            res.vel_array, res.baz_array, res.mdccm_array, res.t_array,
            stdict_all, res.sig_tau_array, res.num_compute_list,
            res.w_array, res.h_array,
        )


def narrow_band_loop(
    ii: int,
    freqlist: Sequence[float],
    FREQ_BAND_TYPE: str,
    freq_resp_list: np.ndarray,
    st: ArrayStream,
    FILTER_TYPE: str,
    FILTER_ORDER: int,
    FILTER_RIPPLE: float,
    lat_list: Sequence[float],
    lon_list: Sequence[float],
    WINLEN_list: Sequence[float],
    WINOVER: float,
    ALPHA: float,
    vector_len: int,
    *,
    device=None,
):
    """One band's work, the reference's parallel-worker contract.

    Returns the 10-tuple ``(vel, baz, mdccm, t, stdict_times,
    stdict_elements, sig_tau, num_compute, w, h)`` of reference
    ``narrow_band_least_squares.py:134-218``, every vector padded to
    ``vector_len``; with ``ALPHA < 1`` the band's stdict flattened into two
    parallel object arrays (keys, values), None for OLS.
    """
    from scipy import signal as _signal

    tempfmin, tempfmax = band_edges(freqlist, ii, FREQ_BAND_TYPE)
    stf, Fs, sos = filter_data(
        st, FILTER_TYPE, tempfmin, tempfmax, FILTER_ORDER, FILTER_RIPPLE,
        device=device,
    )
    w_temp, h_temp = _signal.sosfreqz(sos, freq_resp_list, fs=Fs)

    temp_BT = WINLEN_list[ii] * (tempfmax - tempfmin)
    if temp_BT < 5.0:
        print(
            "CAUTION: BT < 5! Band between " + str(tempfmin) + " Hz and "
            + str(tempfmax) + " Hz has BT = " + str(temp_BT)
        )

    vel, baz, t, mdccm, stdict, sig_tau, _, _ = ltsva(
        stf, lat_list, lon_list, WINLEN_list[ii], WINOVER, ALPHA,
        device=device,
    )
    num_compute = np.array(len(vel))
    pad = (0, vector_len - int(num_compute))
    vel_f = np.pad(make_float(vel), pad)
    baz_f = np.pad(make_float(baz), pad)
    mdccm_f = np.pad(make_float(mdccm), pad)
    t_f = np.pad(make_float(t), pad)
    sig_f = np.pad(make_float(sig_tau), pad)
    stdict_times = stdict_elements = None
    if ALPHA != 1.0:
        arr = np.array(list(stdict.items()), dtype=object)
        stdict_times, stdict_elements = arr[:, 0], arr[:, 1]
    return (
        vel_f, baz_f, mdccm_f, t_f, stdict_times, stdict_elements,
        sig_f, num_compute, w_temp, h_temp,
    )


def narrow_band_least_squares_parallel(*args, **kwargs):
    """Parity alias for the reference's joblib path: the bands already run
    as one batched device computation, so both names run the same step."""
    return narrow_band_least_squares(*args, **kwargs)
