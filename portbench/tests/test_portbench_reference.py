"""The reference: its array form equals the frozen per-window oracle, the
copied generator equals the port's, and the port's plain CPU path
(``device="cpu"``) agrees with it at a small size, within the limits the
configuration states."""

import numpy as np
import pytest
from scipy import signal

from portbench.harness.check import Tally
from portbench.harness.spec import Spec
from portbench.reference import batched as RB
from portbench.reference import ltsva, synthetic
from portbench.reference.geometry import get_rij
from portbench.reference.plan import band_edges

SMALL = dict(FS=20.0, FMIN=0.3, FMAX=2.0, NBANDS=3, FREQ_BAND_TYPE="log",
             WINDOW_LENGTH_TYPE="adaptive", WINLEN=50, WINLEN_1=40, WINLEN_X=20,
             WINOVER=0.5, FILTER_TYPE="cheby1", FILTER_ORDER=2, FILTER_RIPPLE=0.01)


def stream(seed=3, nchans=6, duration_s=300.0):
    return synthetic.synthetic_plane_wave(nchans=nchans, duration_s=duration_s, fs=20.0,
                                          baz_deg=140.0, trace_vel_kms=0.33, f0=0.8,
                                          bandwidth=1.2, snr=8.0, seed=seed)


def test_array_form_equals_the_frozen_oracle():
    st = stream()
    rij = get_rij(st.latitudes, st.longitudes, st.data.shape[0])
    dep = RB.Deployment(SMALL, st.data.shape[1])
    got = RB.solve_segment(dep, rij, st.data, st.start_epoch)
    for b in range(dep.nbands):
        lo, hi = band_edges(dep.freqlist, b, "log")
        filt, _ = ltsva.filter_and_taper(st.data, 20.0, "cheby1", lo, hi, 2, 0.01)
        want = ltsva.sliding_window_solve(filt, rij, 20.0, st.start_epoch, dep.winlens[b],
                                          0.5, 1.0, xcorr_method="fft")
        for k in ("vel", "baz", "mdccm", "sig_tau"):
            np.testing.assert_allclose(got[b][k], want[k], rtol=1e-9, atol=1e-12)
        np.testing.assert_array_equal(got[b]["t"], want["t"])


def test_context_is_the_filter_run_from_the_streams_start():
    st = stream(duration_s=600.0)
    rij = get_rij(st.latitudes, st.longitudes, st.data.shape[0])
    dep = RB.Deployment(SMALL, 6000)
    seg = RB.filter_band(dep, 0, st.data[:, 6000:], context=st.data[:, :6000])
    sos = ltsva.design_sos("cheby1", *band_edges(dep.freqlist, 0, "log"), 2, 0.01, 20.0)
    whole = np.stack([signal.sosfilt(sos, row) for row in st.data])
    np.testing.assert_allclose(seg, whole[:, 6000:] * dep.taper[None, :], rtol=1e-12,
                               atol=1e-12)
    assert rij.shape == (2, 6)


def test_generator_equals_the_ports():
    from narrow_band_least_squares_tpu_torch.io import synthetic_plane_wave

    a = stream(seed=11)
    b = synthetic_plane_wave(nchans=6, duration_s=300.0, fs=20.0, baz_deg=140.0,
                             trace_vel_kms=0.33, f0=0.8, bandwidth=1.2, snr=8.0, seed=11)
    np.testing.assert_array_equal(a.data, b.data)
    assert list(a.latitudes) == list(b.latitudes)


def test_ports_cpu_path_agrees_with_the_reference():
    from narrow_band_least_squares_tpu_torch import api
    from narrow_band_least_squares_tpu_torch.io.stream import ArrayStream

    st = stream(seed=5)
    dep = RB.Deployment(SMALL, st.data.shape[1])
    out = api.narrow_band_least_squares(
        dep.winlens, 0.5, 1.0, ArrayStream(st.data, 20.0, st.start_epoch, st.latitudes,
                                           st.longitudes),
        st.latitudes, st.longitudes, dep.nbands, None, None, dep.freqlist, "log",
        np.logspace(-2, 1, 50), "cheby1", 2, 0.01, device="cpu")
    ref = RB.solve_segment(dep, get_rij(st.latitudes, st.longitudes, 6), st.data,
                           st.start_epoch)
    tally = Tally(Spec().config("i53_example")["guarantee"], 20.0)
    tally.add("small", {"vel": out[0], "baz": out[1], "mdccm": out[2], "t": out[3],
                        "sig_tau": out[5], "num_compute": out[6]}, ref)
    n = tally.numbers()
    assert n["missing"]["value"] == 0 and tally.windows == sum(dep.num_compute_list)
    assert tally.correct(), n


@pytest.mark.parametrize("fault", ["times", "count", "none"])
def test_tally_counts_malformed_answers_as_missing(fault):
    st = stream(seed=6)
    dep = RB.Deployment(SMALL, st.data.shape[1])
    ref = RB.solve_segment(dep, get_rij(st.latitudes, st.longitudes, 6), st.data,
                           st.start_epoch)
    W = max(dep.num_compute_list)
    ans = {k: np.stack([np.pad(r[k], (0, W - len(r[k]))) for r in ref])
           for k in ("vel", "baz", "mdccm", "t", "sig_tau")}
    ans["num_compute"] = list(dep.num_compute_list)
    if fault == "times":
        ans["t"][1, 2] += 1.0 / 20.0 / 86400.0
    elif fault == "count":
        ans["num_compute"][0] -= 1
    tally = Tally(Spec().config("i53_example")["guarantee"], 20.0)
    tally.add("x", ans, ref)
    assert tally.numbers()["missing"]["value"] == (0 if fault == "none" else 1)
