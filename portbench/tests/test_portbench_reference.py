"""The reference: its array form equals the frozen per-window oracle (OLS,
and LTS at the oracle's ten C-steps), its LTS at the port's defaults flags
an incoherent element, the copied generator equals the port's, and the
port's plain CPU path (``device="cpu"``) agrees with it at a small size,
within the limits the configuration states.  The check compares the LTS
flags, and its OLS path reads what it read before the LTS check came."""

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


def lts_stream(seed=3):
    """Eight elements, the third incoherent: 28 pairs, 7 of them bad."""
    return synthetic.synthetic_plane_wave(nchans=8, duration_s=300.0, fs=20.0, baz_deg=140.0,
                                          trace_vel_kms=0.33, f0=0.8, bandwidth=1.2, snr=8.0,
                                          seed=seed, outlier_channels=[2])


@pytest.mark.parametrize("alpha", [0.75, 0.5])
def test_lts_at_ten_steps_without_the_funnel_equals_the_frozen_oracle(alpha):
    st = lts_stream()
    rij = get_rij(st.latitudes, st.longitudes, 8)
    dep = RB.Deployment(dict(SMALL, ALPHA=alpha, options={"c_steps": 10}), st.data.shape[1])
    assert (dep.c_steps, dep.funnel) == (10, 0)
    got = RB.solve_segment(dep, rij, st.data, st.start_epoch)
    for b in range(dep.nbands):
        lo, hi = band_edges(dep.freqlist, b, "log")
        filt, _ = ltsva.filter_and_taper(st.data, 20.0, "cheby1", lo, hi, 2, 0.01)
        want = ltsva.sliding_window_solve(filt, rij, 20.0, st.start_epoch, dep.winlens[b],
                                          0.5, alpha, xcorr_method="fft")
        assert want["flags"].sum(-1).tolist() == [28 - RB.lts_h(alpha, 28)] * len(want["t"])
        np.testing.assert_array_equal(got[b]["flags"], want["flags"])
        np.testing.assert_array_equal(got[b]["pairs"], want["pairs"])
        for k in ("vel", "baz", "sig_tau", "mdccm"):
            np.testing.assert_allclose(got[b][k], want[k], rtol=1e-9, atol=1e-12)
        np.testing.assert_array_equal(got[b]["t"], want["t"])


@pytest.mark.parametrize("funnel", [0, "auto"])
@pytest.mark.parametrize("alpha", [0.75, 0.5])
def test_lts_at_the_ports_defaults_flags_the_incoherent_element(alpha, funnel):
    """In the windows the wave makes coherent (MdCCM over 0.6), LTS drops
    the 7 pairs of element 3: exactly those at ALPHA 0.75 (h = 21 of 28),
    all of them among the 14 at 0.5; a random lag that fits the wave by
    chance keeps a bad pair in a few windows."""
    st = lts_stream(seed=4)
    options = {} if funnel == 0 else {"lts_funnel_k": funnel}
    dep = RB.Deployment(dict(SMALL, ALPHA=alpha, options=options), st.data.shape[1])
    assert (dep.c_steps, dep.funnel) == (RB.LTS_C_STEPS, funnel) == (4, funnel)
    got = RB.solve_segment(dep, get_rij(st.latitudes, st.longitudes, 8), st.data,
                           st.start_epoch)
    for r in got:
        bad = (r["pairs"] == 2).any(-1)
        coherent = r["mdccm"] > 0.6
        assert coherent.sum() >= 10
        flagged = ((r["flags"] == bad).all(-1) if alpha == 0.75 else r["flags"][:, bad].all(-1))
        assert flagged[coherent].mean() >= 0.9
        assert r["flags"].sum(-1).tolist() == [28 - RB.lts_h(alpha, 28)] * len(r["t"])


def test_funnel_survivors_and_h():
    assert [RB.funnel_survivors("auto", q) for q in (28, 378, 7140)] == [16, 16, 298]
    assert RB.funnel_survivors(0, 378) == 0 and RB.funnel_survivors(40, 378) == 40
    assert [RB.lts_h(a, 28) for a in (0.5, 0.75, 1.0)] == [14, 21, 28]
    assert RB.lts_h(0.5, 3) == 3


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


def lts_answer(ref):
    """The answer that agrees with the LTS reference ``ref`` in every window,
    its flags as the entry point reads a ``stdict`` out."""
    W = max(len(r["t"]) for r in ref)
    ans = {k: np.stack([np.pad(r[k], (0, W - len(r[k]))) for r in ref])
           for k in ("vel", "baz", "mdccm", "t", "sig_tau")}
    ans["num_compute"] = [len(r["t"]) for r in ref]
    ans["elements"] = [[sorted(int(e) + 1 for e in r["pairs"][f].ravel()) for f in r["flags"]]
                       for r in ref]
    ans["size"] = 8
    return ans


@pytest.mark.parametrize("fault", ["none", "one_window", "absent", "order", "no_stdict",
                                   "size", "outside"])
def test_tally_compares_the_flagged_elements(fault):
    st = lts_stream(seed=5)
    dep = RB.Deployment(dict(SMALL, ALPHA=0.75), st.data.shape[1])
    ref = RB.solve_segment(dep, get_rij(st.latitudes, st.longitudes, 8), st.data,
                           st.start_epoch)
    ans = lts_answer(ref)
    els = ans["elements"]
    if fault == "one_window":        # one element of one window read as the next
        els[1][2] = els[1][2][:-1] + [els[1][2][-1] % 8 + 1]
    elif fault == "absent":
        els[2][0] = None
    elif fault == "order":           # the same multiset in another order agrees
        els[0][0] = els[0][0][::-1]
    elif fault == "no_stdict":
        del ans["elements"], ans["size"]
    elif fault == "size":
        ans["size"] = 7
    elif fault == "outside":
        els[0][1] = els[0][1][:-1] + [9]
    tally = Tally(Spec().config("i53_example")["guarantee"], 20.0)
    tally.add("x", ans, ref)
    n = tally.numbers()
    missing = fault in ("no_stdict", "size")
    off = 0 if fault in ("none", "order") or missing else 1
    assert n["missing"]["value"] == int(missing)
    assert tally.mismatched == off and tally.windows == (0 if missing else
                                                         sum(ans["num_compute"]))


# The check of `i53.archive` on the CPU for one seed and one call, as the
# code before the LTS check read it: the OLS cells' reference, entry point
# and comparison still read the same.  Its reference a band, summed.
OLS_SEED = 2 ** 31 + 1
OLS_CHECKS = {"missing": 0, "mdccm_err": 6.817012565552005e-07,
              "window_share": 0.002257336343115124}           # 1 window of 443
OLS_REFERENCE = {
    "vel": [12.877779162308032, 13.862221360300587, 15.180076411618879, 16.495383210217103,
            18.471697416422163, 20.452040596120074, 22.762714131170018, 26.058202960895592],
    "baz": [9160.503507883752, 9864.791396723222, 10804.205841074501, 11743.703826124383,
            13152.760367223837, 14561.927890509014, 16206.02322423008, 18555.240461578214],
    "mdccm": [36.73733909356755, 39.80525070693464, 43.32912633215761, 46.891468015848844,
              51.926644427301675, 56.89212410697727, 60.55298351221631, 60.762008108820986],
    "sig_tau": [0.6463512988632232, 0.6647817446857938, 0.7174940388265552,
                0.7800417093221099, 0.8734826662549924, 0.9654933080533767,
                1.072835164998943, 1.2826124599334838],
}


def test_the_ols_check_reads_as_before(run):
    from portbench.harness.traffic import Traffic

    spec = Spec()
    cfg = spec.config("i53_example")
    traffic = Traffic(cfg, spec.traffic("archive"), OLS_SEED)
    dep = RB.Deployment(cfg, traffic.npts)
    assert dep.alpha == 1.0
    ref = RB.solve_segment(dep, get_rij(traffic.lats, traffic.lons, 8), traffic.segment(3),
                           traffic.segment_epoch(3))
    assert all(set(r) == {"vel", "baz", "mdccm", "t", "sig_tau"} for r in ref)
    for k, sums in OLS_REFERENCE.items():
        np.testing.assert_allclose([np.sum(r[k]) for r in ref], sums, rtol=1e-9)
    # one call in the window: segment 3, after the three warm-up calls
    rc, last, _ = run(["--workload", "i53.archive", "--seed", str(OLS_SEED), "--seconds",
                       "0.01", "--trace", "0"])
    assert rc == 0 and last["correct"] is True and last["attempted"] == 1
    got = {k: v["value"] for k, v in last["checks"].items()}
    assert list(got) == list(OLS_CHECKS)
    assert got["missing"] == 0 and got["window_share"] == OLS_CHECKS["window_share"]
    assert got["mdccm_err"] == pytest.approx(OLS_CHECKS["mdccm_err"], rel=1e-6)
