"""Narrow-band least-squares example driver (sequential API path).

The port's counterpart of ``examples/example.py``, itself a mirror of the
reference driver (reference ``example.py``): broadband pass, narrow-band
pass and the full figure set.  The reference fetches the 2018-12-19 Alaska
meteor from IRIS (``example.py:91``); this driver works offline and
synthesizes an equivalent plane-wave event.  Run:

    python -m narrow_band_least_squares_tpu_torch.examples.example [--cpu]

Figures go to ``build/torch_examples/example_figures/``.
"""

import math
import os

import numpy as np
from scipy import signal

from narrow_band_least_squares_tpu_torch import api
from narrow_band_least_squares_tpu_torch.examples import OUT_ROOT, device_from_argv
from narrow_band_least_squares_tpu_torch.io import synthetic_plane_wave

##############################################################################
### User Input (same knobs as the reference driver, example.py:38-72) ###
NCHANS = 8
FS = 20.0
END_OFFSET_S = 20 * 60

FMIN = 0.1
FMAX = 5.0
NBANDS = 8
FREQ_BAND_TYPE = "log"
FILTER_TYPE = "cheby1"
FILTER_ORDER = 2
FILTER_RIPPLE = 0.01

WINOVER = 0.5
WINDOW_LENGTH_TYPE = "adaptive"
WINLEN = 50
WINLEN_1 = 60
WINLEN_X = 30

ALPHA = 1.0
MDCCM_THRESH = 0.6
PLOT_ARRAY_COORDINATES = False

file_type = ".png"
dpi_num = 300
##############################################################################

FIG_DIR = os.path.join(OUT_ROOT, "example_figures")


def get_stream():
    """The example event, synthesized (examples/example.py's offline
    stream)."""
    return synthetic_plane_wave(
        nchans=NCHANS, duration_s=END_OFFSET_S, fs=FS, baz_deg=230.0,
        trace_vel_kms=0.34, f0=0.8, bandwidth=1.4, snr=6.0, seed=42,
    )


def main(argv=None):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from narrow_band_least_squares_tpu_torch.plotting import (
        broadband_filter_response_plot,
        broadband_plot,
        narrow_band_lts_dropped_station_plot,
        narrow_band_lts_plot,
        narrow_band_plot,
        narrow_band_processing_parameters_plot,
        narrow_band_stau_plot,
    )

    device = device_from_argv(argv)
    os.makedirs(FIG_DIR, exist_ok=True)

    def save(fig, name):
        fig.savefig(os.path.join(FIG_DIR, name + file_type), dpi=dpi_num)
        plt.close(fig)

    st = get_stream()
    latlist, lonlist = st.latitudes, st.longitudes
    rij = api.get_rij(latlist, lonlist, st.nchans)

    ### Broadband least-squares ###
    stf_broad, Fs, sos = api.filter_data(
        st, FILTER_TYPE, FMIN, FMAX, FILTER_ORDER, FILTER_RIPPLE, device=device,
    )
    (vel_b, baz_b, t_b, mdccm_b, stdict_b, sig_tau_b, vu_b, bu_b) = api.ltsva(
        stf_broad, latlist, lonlist, WINLEN, WINOVER, ALPHA,
        PLOT_ARRAY_COORDINATES, device=device,
    )
    save(broadband_plot(
        stf_broad, vel_b, baz_b, mdccm_b, t_b, MDCCM_THRESH, ALPHA,
        stdict_b, sig_tau_b,
    ), "Broadband_Least_Squares")

    freq_resp_list = np.logspace(
        math.log(0.01, 10), math.log(Fs / 2, 10), num=1000
    )
    w_broad, h_broad = signal.sosfreqz(sos, freq_resp_list, fs=Fs)
    save(broadband_filter_response_plot(
        w_broad, h_broad, FMIN, FMAX, FILTER_TYPE, FILTER_ORDER, FILTER_RIPPLE
    ), "Filter_Frequency_Response_Broadband")

    ### Narrow-band least-squares ###
    freqlist, nbands, fmax = api.get_freqlist(FMIN, FMAX, FREQ_BAND_TYPE, NBANDS)
    WINLEN_list = api.get_winlenlist(
        WINDOW_LENGTH_TYPE, nbands, WINLEN, WINLEN_1, WINLEN_X
    )
    (vel_array, baz_array, mdccm_array, t_array, stdict_all, sig_tau_array,
     num_compute_list, w_array, h_array) = api.narrow_band_least_squares(
        WINLEN_list, WINOVER, ALPHA, st, latlist, lonlist, nbands,
        w_broad, h_broad, freqlist, FREQ_BAND_TYPE, freq_resp_list,
        FILTER_TYPE, FILTER_ORDER, FILTER_RIPPLE, device=device,
    )

    save(narrow_band_plot(
        FMIN, fmax, stf_broad, nbands, freqlist, FREQ_BAND_TYPE,
        vel_array, baz_array, mdccm_array, t_array, num_compute_list,
        MDCCM_THRESH,
    ), "Narrow_Band_Least_Squares")

    if ALPHA == 1.0:
        save(narrow_band_stau_plot(
            FMIN, fmax, stf_broad, nbands, freqlist, FREQ_BAND_TYPE,
            vel_array, baz_array, mdccm_array, t_array, sig_tau_array,
            num_compute_list, MDCCM_THRESH, ALPHA,
        ), "Narrow_Band_Least_Squares_Sigma_Tau")
    else:
        save(narrow_band_lts_plot(
            FMIN, fmax, stf_broad, nbands, freqlist, FREQ_BAND_TYPE,
            vel_array, baz_array, mdccm_array, t_array, stdict_all,
            num_compute_list, MDCCM_THRESH, ALPHA,
        ), "Narrow_Band_Least_Squares_LTS")
        save(narrow_band_lts_dropped_station_plot(
            FMIN, fmax, stf_broad, nbands, freqlist, FREQ_BAND_TYPE,
            vel_array, baz_array, mdccm_array, t_array, stdict_all,
            num_compute_list, MDCCM_THRESH,
        ), "Narrow_Band_Least_Squares_LTS_Dropped_Stations")

    save(narrow_band_processing_parameters_plot(
        rij, FREQ_BAND_TYPE, freqlist, WINLEN_list, nbands, FMIN, fmax,
        w_array, h_array, FILTER_TYPE, FILTER_ORDER, FILTER_RIPPLE,
    ), "Narrow_Band_Processing_Parameters")
    print(f"Figures written to {FIG_DIR}")
    return num_compute_list, mdccm_array, baz_array, vel_array


if __name__ == "__main__":
    main()
