"""Continuous-monitoring example: the reference's weeks/months workflow.

The port's counterpart of ``examples/example_monitoring.py``.  The
reference handles long durations by manually re-running per segment,
appending text files and re-reading them for ``baz_freq_plot``.  Here the
same workflow is `StreamingMonitor`: segmented processing with
checkpoint/resume and the same TSV format, then the monitoring figures.
Run (offline, synthetic data):

    python -m narrow_band_least_squares_tpu_torch.examples.example_monitoring [--cpu]

Re-running resumes: already-processed segments are skipped.  Results go to
``build/torch_examples/monitoring_out/``, figures to
``build/torch_examples/example_figures/``.
"""

import os

import numpy as np

from narrow_band_least_squares_tpu_torch.examples import OUT_ROOT, device_from_argv
from narrow_band_least_squares_tpu_torch.io import synthetic_plane_wave
from narrow_band_least_squares_tpu_torch.models.streaming import StreamingMonitor
from narrow_band_least_squares_tpu_torch.utils.geometry import get_rij
from narrow_band_least_squares_tpu_torch.utils.plan import (
    get_freqlist,
    get_winlenlist,
    make_plan,
)

NCHANS, FS = 8, 20.0
FMIN, FMAX, NBANDS = 0.1, 5.0, 8
WINLEN, WINLEN_1, WINLEN_X = 50, 60, 30
SEGMENT_S = 1200.0
HOURS = 6.0
MDCCM_THRESH = 0.6
dpi_num = 200

SAVE_DIR = os.path.join(OUT_ROOT, "monitoring_out")
FIG_DIR = os.path.join(OUT_ROOT, "example_figures")


def main(argv=None):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from narrow_band_least_squares_tpu_torch.plotting import (
        baz_freq_plot,
        monitoring_uncertainty_plot,
    )

    device = device_from_argv(argv)
    os.makedirs(FIG_DIR, exist_ok=True)

    # a long stream whose source direction drifts between segments would be
    # the real use case; the synthetic source is fixed at 230 deg
    st = synthetic_plane_wave(
        nchans=NCHANS, duration_s=HOURS * 3600.0, fs=FS, baz_deg=230.0,
        trace_vel_kms=0.34, f0=0.8, bandwidth=1.4, snr=6.0, seed=42,
    )
    freqlist, nbands, fmax = get_freqlist(FMIN, FMAX, "log", NBANDS)
    winlens = get_winlenlist("adaptive", nbands, WINLEN, WINLEN_1, WINLEN_X)
    plan = make_plan(freqlist, "log", winlens, 0.5, int(SEGMENT_S * st.fs), st.fs)
    rij = get_rij(st.latitudes, st.longitudes, st.nchans)

    with StreamingMonitor(plan, rij, SAVE_DIR, freqlist, alpha=1.0,
                          device=device) as mon:
        recs = mon.process(st)  # resume-aware
        print(f"processed {len(recs)} new segments (resume skips existing)")
        vel, baz, mdccm, t, num, extras = mon.read_all(extras=True)

    fig = baz_freq_plot(
        FMIN, fmax, nbands, freqlist, vel, baz, mdccm, t, num, MDCCM_THRESH
    )
    out = os.path.join(FIG_DIR, "Monitoring_Backazimuth_vs_Frequency.png")
    fig.savefig(out, dpi=dpi_num)
    plt.close(fig)

    # the npz sidecars carry what the TSV format cannot: per-window
    # uncertainties (and LTS flags) for the long-duration raster
    fig = monitoring_uncertainty_plot(
        FMIN, fmax, nbands, freqlist, extras["vel_uncert"],
        extras["baz_uncert"], mdccm, t, num, MDCCM_THRESH,
        flags=extras.get("flags"),
    )
    out2 = os.path.join(FIG_DIR, "Monitoring_Uncertainty_vs_Frequency.png")
    fig.savefig(out2, dpi=dpi_num)
    plt.close(fig)

    good = mdccm > MDCCM_THRESH
    print(
        f"{int(good.sum())} confident windows over {HOURS} h; "
        f"median baz {np.median(baz[good]):.1f} deg; figure -> {out}"
    )
    return recs, baz[good]


if __name__ == "__main__":
    main()
