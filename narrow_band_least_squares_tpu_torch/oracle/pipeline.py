"""CPU oracle for the narrow-band orchestrator.

Reproduces reference ``narrow_band_least_squares.py:8-127`` (sequential path)
on an ArrayStream: per band, filter -> sosfreqz -> BT check -> ltsva ->
dense-prefix writes, with the reference's ``vector_len`` heuristic and the
``"NN_"`` stdict key prefixes.  Used as the golden reference for the batched
device pipeline and as the CPU baseline for benchmarks.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
from scipy import signal

from narrow_band_least_squares_tpu_torch.io.stream import ArrayStream
from narrow_band_least_squares_tpu_torch.oracle.ltsva import (
    filter_and_taper,
    sliding_window_solve,
)
from narrow_band_least_squares_tpu_torch.utils.geometry import get_rij
from narrow_band_least_squares_tpu_torch.utils.plan import (
    band_edges,
    reference_vector_len,
)


def _band_worker(args):
    """One band's filter -> freqz -> sliding solve (picklable for the
    process pool — the analog of reference ``narrow_band_loop``,
    ``narrow_band_least_squares.py:134``)."""
    (ii, data, Fs, start_epoch, rij, freqlist, FREQ_BAND_TYPE,
     FILTER_TYPE, FILTER_ORDER, FILTER_RIPPLE, WINLEN, WINOVER, ALPHA,
     freq_resp_list, xcorr_method) = args
    tempfmin, tempfmax = band_edges(freqlist, ii, FREQ_BAND_TYPE)
    filtered, sos = filter_and_taper(
        data, Fs, FILTER_TYPE, tempfmin, tempfmax,
        FILTER_ORDER, FILTER_RIPPLE,
    )
    w, h = signal.sosfreqz(sos, freq_resp_list, fs=Fs)
    res = sliding_window_solve(
        filtered, rij, Fs, start_epoch, WINLEN, WINOVER, ALPHA,
        xcorr_method=xcorr_method,
    )
    bt = WINLEN * (tempfmax - tempfmin)
    return ii, res, w, h, (tempfmin, tempfmax, bt)


def narrow_band_least_squares_oracle(
    WINLEN_list: Sequence[float],
    WINOVER: float,
    ALPHA: float,
    st: ArrayStream,
    lat_list: Sequence[float],
    lon_list: Sequence[float],
    NBANDS: int,
    freqlist: Sequence[float],
    FREQ_BAND_TYPE: str,
    freq_resp_list: np.ndarray,
    FILTER_TYPE: str,
    FILTER_ORDER: int,
    FILTER_RIPPLE: float,
    verbose: bool = False,
    xcorr_method: str = "time",
    n_jobs: int = 1,
):
    """Sequential narrow-band processing, reference tuple contract.

    Returns ``(vel_array, baz_array, mdccm_array, t_array, stdict_all,
    sig_tau_array, num_compute_list, w_array, h_array)`` like reference
    ``narrow_band_least_squares.py:127``.

    ``xcorr_method='fft'`` switches the per-pair correlation to the honest
    FFT implementation (what the real ``lts_array`` uses); ``n_jobs > 1``
    (or -1 for all cores) fans bands out over a process pool, mirroring the
    reference's ``joblib.Parallel(n_jobs=-1)`` path
    (``narrow_band_least_squares.py:285``).  Both exist so the benchmark
    baseline is the *strongest* defensible CPU reference, not a strawman.
    """
    npts = st.npts
    Fs = st.fs
    vector_len = reference_vector_len(WINLEN_list, WINOVER, npts, Fs)
    rij = get_rij(list(lat_list), list(lon_list), st.nchans)

    # Dense width: the reference np.empty((NBANDS, vector_len)) contract;
    # widened when a band legitimately produces more windows than the quirky
    # heuristic allows (never the case for the canonical configs).
    width = vector_len
    nresp = len(freq_resp_list)

    vel_rows: List[np.ndarray] = []
    baz_rows: List[np.ndarray] = []
    mdccm_rows: List[np.ndarray] = []
    t_rows: List[np.ndarray] = []
    sig_rows: List[np.ndarray] = []
    num_compute_list: List[int] = []
    stdict_all: Optional[Dict[str, object]] = {}
    w_array = np.zeros((NBANDS, nresp), dtype=complex)
    h_array = np.zeros((NBANDS, nresp), dtype=complex)

    worker_args = [
        (ii, st.data, Fs, st.start_epoch, rij, list(freqlist),
         FREQ_BAND_TYPE, FILTER_TYPE, FILTER_ORDER, FILTER_RIPPLE,
         WINLEN_list[ii], WINOVER, ALPHA, np.asarray(freq_resp_list),
         xcorr_method)
        for ii in range(NBANDS)
    ]
    if n_jobs == 1:
        band_results = [_band_worker(a) for a in worker_args]
    else:
        import multiprocessing
        from concurrent.futures import ProcessPoolExecutor

        jobs = multiprocessing.cpu_count() if n_jobs in (-1, 0) else n_jobs
        with ProcessPoolExecutor(max_workers=min(jobs, NBANDS)) as pool:
            band_results = list(pool.map(_band_worker, worker_args))

    for ii, res, w, h, (tempfmin, tempfmax, temp_BT) in band_results:
        w_array[ii, :] = w
        h_array[ii, :] = h
        if temp_BT < 5.0 and verbose:
            print(
                f"CAUTION: BT < 5! Band between {tempfmin} Hz and {tempfmax} "
                f"Hz has BT = {temp_BT}"
            )
        n = len(res["vel"])
        width = max(width, n)
        vel_rows.append(res["vel"])
        baz_rows.append(res["baz"])
        mdccm_rows.append(res["mdccm"])
        t_rows.append(res["t"])
        sig_rows.append(res["sig_tau"])
        num_compute_list.append(n)

        if ALPHA == 1.0:
            stdict_all = None
        else:
            # zero-padded band prefix "NN_" on every timestamp key
            # (reference narrow_band_least_squares.py:114-124)
            temp = {}
            for key, val in res["stdict"].items():
                if key != "size":
                    temp[str(ii + 1).zfill(2) + "_" + key] = val
                else:
                    temp["size"] = val
            stdict_all = {**stdict_all, **temp}

    vel_array = np.zeros((NBANDS, width))
    baz_array = np.zeros((NBANDS, width))
    mdccm_array = np.zeros((NBANDS, width))
    t_array = np.zeros((NBANDS, width))
    sig_tau_array = np.zeros((NBANDS, width))
    for ii in range(NBANDS):
        n = num_compute_list[ii]
        vel_array[ii, :n] = vel_rows[ii]
        baz_array[ii, :n] = baz_rows[ii]
        mdccm_array[ii, :n] = mdccm_rows[ii]
        t_array[ii, :n] = t_rows[ii]
        sig_tau_array[ii, :n] = sig_rows[ii]

    return (
        vel_array, baz_array, mdccm_array, t_array, stdict_all,
        sig_tau_array, num_compute_list, w_array, h_array,
    )
