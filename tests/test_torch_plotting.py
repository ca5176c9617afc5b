"""PyTorch port: the parity figures (`plotting`) against the JAX package's.

- All nine figure functions, fed the same NumPy inputs (and each package's
  own ``ArrayStream`` of the same data), render the same pixels: the Agg
  RGBA buffers at a fixed size and dpi are equal.  A difference is a fault
  of the port, not a tolerance.
- ``tests/test_plotting_structure.py``'s structural checks (patch and
  scatter counts from the threshold semantics, colour clipping, limits,
  panel counts), on the port's own CPU results.
- ``monitoring_uncertainty_plot`` drawn from the port monitor's
  ``read_all(extras=True)``, as ``tests/test_streaming.py`` draws it.
"""

import numpy as np
import pytest

import matplotlib

matplotlib.use("Agg")

import matplotlib.pyplot as plt
from scipy import signal

from narrow_band_least_squares_tpu import plotting as JP
from narrow_band_least_squares_tpu.io.stream import ArrayStream as JStream
from narrow_band_least_squares_tpu_torch import api
from narrow_band_least_squares_tpu_torch import plotting as plot
from narrow_band_least_squares_tpu_torch.io.stream import ArrayStream
from narrow_band_least_squares_tpu_torch.utils.plan import get_freqlist, get_winlenlist

MDCCM_THRESH = 0.6
DPI = 30   # the RGBA comparison's rendering dpi (figure sizes are the functions')


def _port_stream(st):
    return ArrayStream(data=st.data, fs=st.fs, start_epoch=st.start_epoch,
                       latitudes=list(st.latitudes), longitudes=list(st.longitudes),
                       ids=list(st.ids))


def _results(jst, winlens_of, alpha):
    st = _port_stream(jst)
    freqlist, nbands, fmax = get_freqlist(0.2, 1.6, "log", 3)
    winlens = winlens_of(nbands)
    fr = np.logspace(-2, np.log10(st.fs / 2), 60)
    out = api.narrow_band_least_squares(
        winlens, 0.5, alpha, st, st.latitudes, st.longitudes,
        nbands, None, None, freqlist, "log", fr, "cheby1", 2, 0.01, device="cpu",
    )
    stf, _, _ = api.filter_data(st, "cheby1", 0.2, 1.6, 2, 0.01, device="cpu")
    return st, stf, freqlist, nbands, winlens, out


@pytest.fixture(scope="module")
def ols_results(small_stream):
    return _results(small_stream, lambda nb: get_winlenlist("adaptive", nb, 30, 40, 20), 1.0)


@pytest.fixture(scope="module")
def lts_results(outlier_stream):
    return _results(outlier_stream, lambda nb: get_winlenlist("constant", nb, 30, 0, 0), 0.75)


@pytest.fixture(scope="module")
def monitor_extras(outlier_stream, tmp_path_factory):
    """The port monitor (LTS, two 120 s segments) on the CPU, read back
    with its npz sidecars."""
    from narrow_band_least_squares_tpu_torch.models import StreamingMonitor
    from narrow_band_least_squares_tpu_torch.utils import get_rij, make_plan

    st = _port_stream(outlier_stream)
    freqlist, nbands, _ = get_freqlist(0.2, 1.6, "log", 3)
    plan = make_plan(freqlist, "log", get_winlenlist("constant", nbands, 30, 0, 0), 0.5,
                     int(120 * st.fs), st.fs)
    rij = get_rij(st.latitudes, st.longitudes, st.nchans)
    with StreamingMonitor(plan, rij, str(tmp_path_factory.mktemp("mon")), freqlist,
                          alpha=0.75, device="cpu") as mon:
        assert len(mon.process(st)) == 2
        return nbands, freqlist, mon.read_all(extras=True)


def _rgba(fig):
    fig.set_dpi(DPI)
    fig.canvas.draw()
    out = np.asarray(fig.canvas.buffer_rgba()).copy()
    plt.close(fig)
    return out


def _figure_args(name, ols, lts, mon):
    """(port args, JAX args) of figure ``name``: equal NumPy inputs, each
    package's own stream."""
    if name == "monitoring_uncertainty_plot":
        nb, freqlist, (vel, baz, mdccm, t, num, ex) = mon
        a = (0.2, 1.6, nb, freqlist, ex["vel_uncert"], ex["baz_uncert"], mdccm, t, num,
             MDCCM_THRESH)
        return a + (ex["flags"],), a + (ex["flags"],)
    if name == "monitoring_uncertainty_plot/no-flags":
        nb, freqlist, (vel, baz, mdccm, t, num, ex) = mon
        a = (0.2, 1.6, nb, freqlist, ex["vel_uncert"], ex["baz_uncert"], mdccm, t, num,
             MDCCM_THRESH)
        return a, a
    lts_case = name.endswith("/lts") or "lts" in name.split("/")[0]
    st, stf, freqlist, nbands, winlens, out = lts if lts_case else ols
    jstf = JStream(data=stf.data, fs=stf.fs, start_epoch=stf.start_epoch,
                   latitudes=list(stf.latitudes), longitudes=list(stf.longitudes),
                   ids=list(stf.ids))
    vel_a, baz_a, mdccm_a, t_a, stdict, sig_a, num, w_a, h_a = out
    base = name.split("/")[0]
    if base == "broadband_filter_response_plot":
        from narrow_band_least_squares_tpu_torch.ops.filters import design_sos

        sos = design_sos("cheby1", 0.2, 1.6, 2, 0.01, st.fs)
        w, h = signal.sosfreqz(sos, np.logspace(-2, np.log10(st.fs / 2), 100), fs=st.fs)
        a = (w, h, 0.2, 1.6, "cheby1", 2, 0.01)
        return a, a
    if base == "broadband_plot":
        alpha = 0.75 if lts_case else 1.0
        vel, baz, t, mdccm, sd, sig, _, _ = api.ltsva(
            stf, st.latitudes, st.longitudes, 30, 0.5, alpha, device="cpu")
        rest = (vel, baz, mdccm, t, MDCCM_THRESH, alpha, sd, sig)
        return (stf,) + rest, (jstf,) + rest
    if base == "narrow_band_processing_parameters_plot":
        rij = api.get_rij(st.latitudes, st.longitudes, st.nchans)
        a = (rij, "log", freqlist, winlens, nbands, 0.2, 1.6, w_a, h_a, "cheby1", 2, 0.01)
        return a, a
    if base == "baz_freq_plot":
        a = (0.2, 1.6, nbands, freqlist, vel_a, baz_a, mdccm_a, t_a, num, MDCCM_THRESH)
        return a, a
    head = (0.2, 1.6)
    tail = {
        "narrow_band_plot": (nbands, freqlist, "log", vel_a, baz_a, mdccm_a, t_a, num,
                             MDCCM_THRESH),
        "narrow_band_stau_plot": (nbands, freqlist, "log", vel_a, baz_a, mdccm_a, t_a,
                                  sig_a, num, MDCCM_THRESH, 1.0),
        "narrow_band_lts_plot": (nbands, freqlist, "log", vel_a, baz_a, mdccm_a, t_a,
                                 stdict, num, 0.5, 0.75),
        "narrow_band_lts_dropped_station_plot": (nbands, freqlist, "log", vel_a, baz_a,
                                                 mdccm_a, t_a, stdict, num, 0.5),
    }[base]
    return head + (stf,) + tail, head + (jstf,) + tail


FIGURES = [
    "broadband_filter_response_plot",
    "broadband_plot",
    "broadband_plot/lts",
    "narrow_band_processing_parameters_plot",
    "narrow_band_plot",
    "narrow_band_stau_plot",
    "narrow_band_lts_plot",
    "narrow_band_lts_dropped_station_plot",
    "monitoring_uncertainty_plot",
    "monitoring_uncertainty_plot/no-flags",
    "baz_freq_plot",
]


def test_every_public_figure_is_compared():
    public = {n for n in dir(JP) if n.endswith("_plot") and not n.startswith("_")}
    assert public == {f.split("/")[0] for f in FIGURES}
    assert len(public) == 9
    assert all(callable(getattr(plot, n)) for n in public)


@pytest.mark.parametrize("name", FIGURES)
def test_figure_pixels_equal_jax(name, ols_results, lts_results, monitor_extras):
    targs, jargs = _figure_args(name, ols_results, lts_results, monitor_extras)
    base = name.split("/")[0]
    got = _rgba(getattr(plot, base)(*targs))
    want = _rgba(getattr(JP, base)(*jargs))
    assert got.shape == want.shape and got.shape[2] == 4
    assert (got[..., :3] < 250).any(), "blank figure"
    np.testing.assert_array_equal(got, want)


def test_monitoring_uncertainty_plot_from_the_monitor(monitor_extras):
    nb, freqlist, (vel, baz, mdccm, t, num, ex) = monitor_extras
    assert ex["flags"].shape[:2] == mdccm.shape and ex["flags"].any()
    fig = plot.monitoring_uncertainty_plot(
        0.2, 1.6, nb, freqlist, ex["vel_uncert"], ex["baz_uncert"],
        mdccm, t, num, MDCCM_THRESH, flags=ex["flags"],
    )
    assert len(fig.axes) == 4  # 3 panels + colorbar
    assert fig.axes[2].get_ylim() == (-0.02, 1.0)
    plt.close(fig)


# --------------------------------------------------------------------------
# tests/test_plotting_structure.py on the port's results
# --------------------------------------------------------------------------

def _expected_counts(mdccm_a, vel_a, num):
    """Window counts implied by the reference's threshold semantics."""
    drawable = above_rects = good_pts = phys_pts = 0
    for b in range(mdccm_a.shape[0]):
        n = int(num[b])
        md = mdccm_a[b, :n]
        # rasters draw rect jj only when window jj+1 exists (width = gap)
        drawable += max(n - 1, 0)
        above_rects += int((md[: n - 1] >= MDCCM_THRESH).sum())
        good = md > MDCCM_THRESH
        good_pts += int(good.sum())
        vel = vel_a[b, :n]
        phys_pts += int((good & (vel > 0.25) & (vel < 0.45)).sum())
    return drawable, above_rects, good_pts, phys_pts


def _scatter_points(ax):
    return sum(len(c.get_offsets()) for c in ax.collections)


def test_narrow_band_plot_structure(ols_results):
    st, stf, freqlist, nbands, winlens, out = ols_results
    vel_a, baz_a, mdccm_a, t_a, _, sig_a, num, w_a, h_a = out
    drawable, above, good, _ = _expected_counts(mdccm_a, vel_a, num)
    assert good > 0, "fixture produced no confident windows"

    fig = plot.narrow_band_plot(
        0.2, 1.6, stf, nbands, freqlist, "log",
        vel_a, baz_a, mdccm_a, t_a, num, MDCCM_THRESH,
    )
    # 6 content panels + 3 fixed colorbars + 1 frequency colorbar
    assert len(fig.axes) == 10
    ax0, ax_m, ax_b, ax_v, ax_sb, ax_sv = fig.axes[:6]

    # panel a: the pressure trace
    assert len(ax0.lines) == 1
    assert len(ax0.lines[0].get_xdata()) == stf.npts

    # rasters: MdCCM draws every drawable window (below-threshold at half
    # alpha), baz/vel draw only above-threshold windows
    assert len(ax_m.patches) == drawable
    assert len(ax_b.patches) == above
    assert len(ax_v.patches) == above
    n_half = sum(1 for p in ax_m.patches if p.get_alpha() == 0.5)
    assert n_half == drawable - above

    # scatters: one point per above-threshold window, clim = (FMIN, FMAX)
    assert _scatter_points(ax_sb) == good
    assert _scatter_points(ax_sv) == good
    for ax in (ax_sb, ax_sv):
        for c in ax.collections:
            assert c.get_clim() == (0.2, 1.6)

    # fixed panel limits (reference plotting.py:344-360,472)
    assert ax_sb.get_ylim() == (0.0, 360.0)
    assert ax_sv.get_ylim() == (0.2, 0.5)
    plt.close(fig)


def test_narrow_band_plot_threshold_masking(ols_results):
    """Raising the threshold above every MdCCM must empty the baz/vel
    rasters and scatters but keep the (half-alpha) MdCCM raster."""
    st, stf, freqlist, nbands, winlens, out = ols_results
    vel_a, baz_a, mdccm_a, t_a, _, sig_a, num, w_a, h_a = out
    fig = plot.narrow_band_plot(
        0.2, 1.6, stf, nbands, freqlist, "log",
        vel_a, baz_a, mdccm_a, t_a, num, 1.01,
    )
    ax0, ax_m, ax_b, ax_v, ax_sb, ax_sv = fig.axes[:6]
    drawable = sum(max(int(n) - 1, 0) for n in num)
    assert len(ax_m.patches) == drawable
    assert all(p.get_alpha() == 0.5 for p in ax_m.patches)
    assert len(ax_b.patches) == 0
    assert len(ax_v.patches) == 0
    assert _scatter_points(ax_sb) == 0
    assert _scatter_points(ax_sv) == 0
    plt.close(fig)


def test_velocity_color_clipping(ols_results):
    """Velocity raster colors are computed from vel clipped into
    [0.19, 0.51] around a (0.2, 0.5) norm (reference plotting.py:332-338):
    every patch color must equal the turbo colormap at the clipped value."""
    st, stf, freqlist, nbands, winlens, out = ols_results
    vel_a, baz_a, mdccm_a, t_a, _, sig_a, num, w_a, h_a = out
    fig = plot.narrow_band_plot(
        0.2, 1.6, stf, nbands, freqlist, "log",
        vel_a, baz_a, mdccm_a, t_a, num, MDCCM_THRESH,
    )
    ax_v = fig.axes[3]
    from matplotlib.colors import Normalize
    cmap = plt.get_cmap("turbo")
    norm = Normalize(0.2, 0.5)
    expected = []
    for b in range(nbands):
        n = int(num[b])
        vel = vel_a[b, :n].copy()
        vel[vel >= 0.5] = 0.51
        vel[vel <= 0.2] = 0.19
        md = mdccm_a[b, :n]
        sel = (md >= MDCCM_THRESH)[: n - 1]
        expected.extend(cmap(norm(v)) for v in vel[: n - 1][sel])
    got = [p.get_facecolor() for p in ax_v.patches]
    assert len(got) == len(expected)
    np.testing.assert_allclose(np.asarray(got), np.asarray(expected),
                               atol=1e-6)
    plt.close(fig)


def test_stau_plot_structure(ols_results):
    st, stf, freqlist, nbands, winlens, out = ols_results
    vel_a, baz_a, mdccm_a, t_a, _, sig_a, num, w_a, h_a = out
    drawable, above, good, _ = _expected_counts(mdccm_a, vel_a, num)
    fig = plot.narrow_band_stau_plot(
        0.2, 1.6, stf, nbands, freqlist, "log",
        vel_a, baz_a, mdccm_a, t_a, sig_a, num, MDCCM_THRESH, 1.0,
    )
    # 8 content panels + 4 fixed colorbars + 1 frequency colorbar
    assert len(fig.axes) == 13
    ax0, ax_m, ax_sig, ax_b, ax_v, ax_ssig, ax_sb, ax_sv = fig.axes[:8]
    assert len(ax_sig.patches) == above        # sigma_tau raster
    assert _scatter_points(ax_ssig) == good    # sigma_tau scatter
    assert ax_ssig.get_ylim() == (-0.5, 5.0)
    plt.close(fig)


def test_lts_plot_structure(lts_results):
    st, stf, freqlist, nbands, winlens, out = lts_results
    vel_a, baz_a, mdccm_a, t_a, stdict, sig_a, num, w_a, h_a = out
    drawable, above, good, _ = _expected_counts(mdccm_a, vel_a, num)
    fig = plot.narrow_band_lts_plot(
        0.2, 1.6, stf, nbands, freqlist, "log",
        vel_a, baz_a, mdccm_a, t_a, stdict, num, 0.5, 0.75,
    )
    ax0, ax_m, ax_b, ax_v, ax_sb, ax_sv, ax_el = fig.axes[:7]
    n = stdict["size"]
    assert ax_el.get_ylim() == (0.5, n + 0.5)

    # dropped-element scatter: every flagged element of every confident,
    # time-matched window appears exactly once per (window, element)
    expected_pts = 0
    for b in range(nbands):
        md = mdccm_a[b, : int(num[b])]
        tb = np.round(t_a[b, : int(num[b])], 7)
        prefix = str(b + 1).zfill(2) + "_"
        for key, elements in stdict.items():
            if key == "size" or not key.startswith(prefix):
                continue
            hits = np.nonzero(np.isclose(tb, float(key[3:]), rtol=0,
                                         atol=5e-8))[0]
            if len(hits) and md[hits[0]] >= 0.5 and len(elements):
                expected_pts += len(set(np.asarray(elements).tolist()))
    got_pts = _scatter_points(ax_el)
    assert got_pts == expected_pts
    assert expected_pts > 0, "LTS fixture flagged nothing"
    plt.close(fig)


def test_dropped_station_plot_structure(lts_results):
    st, stf, freqlist, nbands, winlens, out = lts_results
    vel_a, baz_a, mdccm_a, t_a, stdict, sig_a, num, w_a, h_a = out
    num_sta = stdict["size"]
    fig = plot.narrow_band_lts_dropped_station_plot(
        0.2, 1.6, stf, nbands, freqlist, "log",
        vel_a, baz_a, mdccm_a, t_a, stdict, num, 0.5,
    )
    # one panel per element + the spanning colorbar
    assert len(fig.axes) == num_sta + 1

    # per-element rect counts: one rect per confident flagged window
    expected = np.zeros(num_sta, dtype=int)
    for b in range(nbands):
        md = mdccm_a[b, : int(num[b])]
        tb = np.round(t_a[b, : int(num[b])], 7)
        prefix = str(b + 1).zfill(2) + "_"
        for key, elements in stdict.items():
            if key == "size" or not key.startswith(prefix):
                continue
            hits = np.nonzero(np.isclose(tb, float(key[3:]), rtol=0,
                                         atol=5e-8))[0]
            if len(hits) and md[hits[0]] >= 0.5 and len(elements):
                for el in set(np.asarray(elements).tolist()):
                    expected[int(el) - 1] += 1
    for k in range(num_sta):
        assert len(fig.axes[k].patches) == expected[k], f"element {k + 1}"
    assert expected.sum() > 0
    plt.close(fig)


def test_baz_freq_plot_structure(ols_results):
    """The monitoring figure double-filters: MdCCM > thresh AND velocity in
    the physical window 0.25-0.45 km/s (reference plotting.py:1228-1240)."""
    st, stf, freqlist, nbands, winlens, out = ols_results
    vel_a, baz_a, mdccm_a, t_a, _, sig_a, num, w_a, h_a = out
    _, _, _, phys = _expected_counts(mdccm_a, vel_a, num)
    fig = plot.baz_freq_plot(
        0.2, 1.6, nbands, freqlist, vel_a, baz_a, mdccm_a, t_a, num,
        MDCCM_THRESH,
    )
    assert len(fig.axes) == 2
    ax1 = fig.axes[0]
    assert _scatter_points(ax1) == phys
    for c in ax1.collections:
        assert c.get_clim() == (0.2, 1.6)
    assert ax1.get_ylim() == (0.0, 360.0)
    plt.close(fig)


def test_broadband_plot_structure(ols_results):
    st, stf, freqlist, nbands, winlens, out = ols_results
    vel, baz, t, mdccm, stdict, sig, vu, bu = api.ltsva(
        stf, st.latitudes, st.longitudes, 30, 0.5, 1.0, device="cpu"
    )
    fig = plot.broadband_plot(stf, vel, baz, mdccm, t, MDCCM_THRESH, 1.0,
                              stdict, sig)
    # 5 content panels + 1 MdCCM colorbar (ALPHA == 1 layout)
    assert len(fig.axes) == 6
    ax0 = fig.axes[0]
    assert len(ax0.lines) == 1
    W = len(np.asarray(vel))
    for ax in fig.axes[1:5]:
        assert _scatter_points(ax) == W
        for c in ax.collections:
            assert c.get_clim() == (0.0, 1.0)
    # MdCCM panel carries the threshold dashed line
    assert any(ln.get_linestyle() == "--" for ln in fig.axes[1].lines)
    # fixed velocity limits (reference plotting.py:115)
    assert fig.axes[3].get_ylim() == (0.2, 0.5)
    plt.close(fig)


def test_processing_parameters_plot_structure(ols_results):
    st, stf, freqlist, nbands, winlens, out = ols_results
    vel_a, baz_a, mdccm_a, t_a, _, sig_a, num, w_a, h_a = out
    rij = api.get_rij(st.latitudes, st.longitudes, st.nchans)
    fig = plot.narrow_band_processing_parameters_plot(
        rij, "log", freqlist, winlens, nbands, 0.2, 1.6,
        w_a, h_a, "cheby1", 2, 0.01,
    )
    assert len(fig.axes) == 3
    ax_geom, ax_win, ax_filt = fig.axes
    assert _scatter_points(ax_geom) == st.nchans       # one dot per element
    assert len(ax_win.patches) == nbands               # one bar per band
    # one response line per band + band-edge vlines (nbands + 1)
    assert len(ax_filt.lines) == nbands + (nbands + 1)
    plt.close(fig)


def test_filter_response_plot_structure(ols_results):
    st, stf, freqlist, nbands, winlens, out = ols_results
    from scipy import signal
    from narrow_band_least_squares_tpu_torch.ops.filters import design_sos

    sos = design_sos("cheby1", 0.2, 1.6, 2, 0.01, st.fs)
    fr = np.logspace(-2, np.log10(st.fs / 2), 100)
    w, h = signal.sosfreqz(sos, fr, fs=st.fs)
    fig = plot.broadband_filter_response_plot(w, h, 0.2, 1.6, "cheby1", 2,
                                              0.01)
    assert len(fig.axes) == 1
    ax = fig.axes[0]
    # response line + two band-edge markers
    assert len(ax.lines) == 3
    resp = ax.lines[0]
    np.testing.assert_allclose(resp.get_ydata(),
                               20 * np.log10(np.abs(h)), atol=1e-9)
    assert ax.get_ylim() == (-5.0, 0.1)
    plt.close(fig)
