"""Parity figures.

The port's copy of ``narrow_band_least_squares_tpu/plotting.py``: the
reference's figure builders (reference ``plotting.py``) against the port's
``ArrayStream`` and NumPy arrays, with the same panel layouts, colormaps,
clip limits and threshold semantics, so that both packages render the same
pixels from the same inputs.  Host matplotlib only: nothing here touches a
device, and no other module of the port imports this one (the command line
does so only when it draws figures).  All functions return a
``matplotlib.figure.Figure``.

Shared semantics (reference ``plotting.py:266-476``):
- dense arrays are consumed through the per-band valid prefix
  ``[:num_compute_list[b]]``;
- frequency-time panels draw one Rectangle per (band, window): x = window
  time, width = gap to the next window, y = band fmin, height = bandwidth;
- MdCCM rasters draw sub-threshold cells at alpha=0.5; baz/velocity rasters
  and the scatter panels draw only cells above MDCCM_THRESH;
- velocity colors are clipped into [0.19, 0.51] around a (0.2, 0.5) norm;
- sigma_tau colors are clipped at 5 around a (0, 5) reversed norm;
- LTS panels parse stdict: strip the "NN_" band prefix, match 7-decimal
  timestamp strings against window times, count flags per element.
"""

from __future__ import annotations

from collections import Counter
from typing import Dict

import numpy as np
import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt
import matplotlib.gridspec as gridspec
import matplotlib.colorbar as cbar
from matplotlib import rcParams
from matplotlib.colors import Normalize
from matplotlib.patches import Rectangle

fonts = 14
rcParams.update({"font.size": fonts})

_LBL = dict(fontsize=fonts + 2, fontweight="bold")


def _band_edges(freqlist, b, freq_band_type):
    if freq_band_type == "2_octave_over":
        return float(freqlist[b]), float(freqlist[b + 2])
    return float(freqlist[b]), float(freqlist[b + 1])


def _valid(arr, b, num_compute_list):
    return np.asarray(arr[b, : int(num_compute_list[b])], dtype=float)


def _clip_vel(vel):
    v = vel.copy()
    v[v >= 0.5] = 0.51
    v[v <= 0.2] = 0.19
    return v


def _stdict_band(stdict: Dict, band: int) -> Dict:
    """Strip the 'NN_' prefix for one band (reference plotting.py:896-905)."""
    band_num = str(band + 1).zfill(2)
    out = {}
    for key, val in stdict.items():
        if key == "size":
            out["size"] = val
        elif key[:2] == band_num:
            out[key[3:]] = val
    return out


def _draw_rects(ax, t, colors, fmin, height, sel):
    """One Rectangle per selected window; width = gap to next window."""
    for jj in np.nonzero(sel[:-1])[0]:
        width = t[jj + 1] - t[jj]
        ax.add_patch(
            Rectangle((t[jj], fmin), width, height, color=colors[jj])
        )


# --------------------------------------------------------------------------
def broadband_filter_response_plot(w, h, FMIN, FMAX, FILTER_TYPE,
                                   FILTER_ORDER, FILTER_RIPPLE):
    """Filter magnitude response (reference plotting.py:17-48)."""
    fig = plt.figure(figsize=(8, 5))
    ax = fig.add_subplot(1, 1, 1)
    ax.semilogx(np.real(w), 20 * np.log10(np.abs(h)))
    ax.axvline(x=FMIN, color="k", ls="--")
    ax.axvline(x=FMAX, color="k", ls="--")
    ax.set_ylabel("Amplitude [dB]", **_LBL)
    ax.set_xlabel("Frequency [Hz]", **_LBL)
    ax.set_ylim(-5, 0.1)
    ax.text(0.02, 0.05, "Filter Type = " + FILTER_TYPE, transform=ax.transAxes)
    ax.text(0.02, 0.1, "Filter Order = " + str(FILTER_ORDER), transform=ax.transAxes)
    if FILTER_TYPE == "cheby1":
        ax.text(0.02, 0.15, "Ripple = " + str(FILTER_RIPPLE), transform=ax.transAxes)
    fig.tight_layout()
    return fig


# --------------------------------------------------------------------------
def broadband_plot(st, vel_array, baz_array, mdccm_array, t_array,
                   MDCCM_THRESH, ALPHA, stdict, sig_tau):
    """5-panel broadband results (reference plotting.py:51-175)."""
    cm = "YlGnBu"
    fig = plt.figure(figsize=(15, 15))
    gs = gridspec.GridSpec(5, 2, width_ratios=[3, 0.1])

    timevec = st[0].times("matplotlib")
    ax0 = fig.add_subplot(gs[0, 0])
    ax0.plot(timevec, np.asarray(st[0]), "k")
    ax0.set_ylabel("Pressure [Pa]", **_LBL)
    ax0.set_xlabel("Time [UTC]", **_LBL)
    ax0.set_title("a)", loc="left", **_LBL)
    ax0.xaxis_date()
    ax0.set_xlim(timevec[1], timevec[-1])

    panels = [
        ("MdCCM", mdccm_array, (0, 1), "b)"),
        ("Backazimuth [deg]", baz_array, (0, 360), "c)"),
        ("Trace Velocity [km/s]", vel_array, (0.2, 0.5), "d)"),
    ]
    sc = None
    for i, (label, data, ylim, tag) in enumerate(panels, start=1):
        ax = fig.add_subplot(gs[i, 0])
        sc = ax.scatter(t_array, data, c=mdccm_array, edgecolors="k",
                        lw=0.3, cmap=cm)
        sc.set_clim([0, 1.0])
        ax.set_ylabel(label, **_LBL)
        ax.set_xlabel("Time [UTC]", **_LBL)
        ax.set_title(tag, loc="left", **_LBL)
        ax.xaxis_date()
        ax.set_ylim(*ylim)
        ax.set_xlim(t_array[0], t_array[-1])
        if label == "MdCCM":
            ax.plot([t_array[0], t_array[-1]], [MDCCM_THRESH] * 2, "k--")

    ax4 = fig.add_subplot(gs[4, 0])
    if ALPHA == 1.0:
        sc_last = ax4.scatter(t_array, sig_tau, c=mdccm_array,
                              edgecolors="k", lw=0.3, cmap=cm)
        sc_last.set_clim([0, 1.0])
        ax4.set_ylim(-0.5, 5)
        ax4.set_ylabel(r"Sigma Tau ($\sigma_\tau$)", fontsize=fonts,
                       fontweight="bold")
        cax = fig.add_subplot(gs[1:5, 1])
        hc = fig.colorbar(sc, cax=cax)
        hc.set_label("MdCCM", fontsize=fonts, fontweight="bold")
    else:
        n = stdict["size"]
        cm2 = plt.get_cmap("binary", n - 1)
        ax4.scatter(np.array([t_array[0], t_array[-1]]),
                    np.array([0.01, 0.01]), c="w")
        ax4.axis("tight")
        ax4.set_ylabel("Element [#]", **_LBL)
        ax4.set_ylim(0.5, n + 0.5)
        sc2 = None
        for key, elements in stdict.items():
            if key == "size":
                continue
            z = Counter(list(elements))
            keys = np.array(list(z.keys()))
            vals = np.array(list(z.values()))
            if len(keys) == 0:
                continue
            pts = np.full(len(keys), float(key))
            sc2 = ax4.scatter(pts, keys, c=vals, edgecolors="k", lw=0.1,
                              cmap=cm2, vmin=0.5, vmax=n - 0.5)
        if sc2 is not None:
            cax = fig.add_subplot(gs[4, 1])
            hc = fig.colorbar(sc2, orientation="vertical", cax=cax)
            hc.set_label("# of Flagged\nElement Pairs", **_LBL)
        cax = fig.add_subplot(gs[1:4, 1])
        hc = fig.colorbar(sc, cax=cax)
        hc.set_label("MdCCM", fontsize=fonts, fontweight="bold")

    ax4.set_title("e)", loc="left", **_LBL)
    ax4.set_xlabel("Time [UTC]", **_LBL)
    ax4.xaxis_date()
    ax4.set_xlim(t_array[0], t_array[-1])
    fig.tight_layout()
    return fig


# --------------------------------------------------------------------------
def narrow_band_processing_parameters_plot(rij, FREQ_BAND_TYPE, freqlist,
                                           WINLEN_list, NBANDS, FMIN, FMAX,
                                           w_array, h_array, FILTER_TYPE,
                                           FILTER_ORDER, FILTER_RIPPLE):
    """3-panel processing diagnostics (reference plotting.py:179-259)."""
    heights = [
        _band_edges(freqlist, b, FREQ_BAND_TYPE)[1]
        - _band_edges(freqlist, b, FREQ_BAND_TYPE)[0]
        for b in range(NBANDS)
    ]
    fig = plt.figure(figsize=(10, 10))
    gs = gridspec.GridSpec(2, 2)

    ax0 = fig.add_subplot(gs[0, 0])
    ax0.scatter(rij[0], rij[1])
    ax0.set_xlabel("X [km]", **_LBL)
    ax0.set_ylabel("Y [km]", **_LBL)
    ax0.axis("square")
    ax0.grid()
    ax0.set_title("a) Array Geometry", loc="left", **_LBL)

    ax1 = fig.add_subplot(gs[0, 1])
    if FREQ_BAND_TYPE == "2_octave_over":
        ax1.barh(freqlist[:-2], WINLEN_list, height=heights, align="edge",
                 color="grey", edgecolor="k", alpha=0.25)
    else:
        ax1.barh(freqlist[:-1], WINLEN_list, height=heights, align="edge",
                 color="grey", edgecolor="k", alpha=0.5)
    if FREQ_BAND_TYPE == "linear":
        ax1.set_ylim(-0.1, FMAX + 1)
    else:
        ax1.set_yscale("log")
        ax1.set_ylim(FMIN, FMAX + (2 if FMAX < 10 else 10))
    ax1.set_xlabel("Window Length [s]", **_LBL)
    ax1.set_ylabel("Frequency [Hz]", **_LBL)
    ax1.set_title("b) Window Length", loc="left", **_LBL)
    ax1.text(0.02, 0.95, "# of Bands = " + str(NBANDS),
             transform=ax1.transAxes, ha="left", fontsize=fonts - 2)
    ax1.text(0.98, 0.95,
             f"FMIN = {round(FMIN, 2)}, FMAX = {round(FMAX, 2)}",
             transform=ax1.transAxes, ha="right", fontsize=fonts - 2)

    ax2 = fig.add_subplot(gs[1, 0:2])
    for b in range(NBANDS):
        wb = np.real(w_array[b, :-1])
        hb = np.abs(h_array[b, :-1])
        with np.errstate(divide="ignore"):
            mag = 20 * np.log10(hb)
        if FREQ_BAND_TYPE == "linear":
            ax2.plot(wb, mag)
        else:
            ax2.semilogx(wb, mag)
        ax2.axvline(x=freqlist[b], ymax=0.9, color="k", ls="--")
    ax2.axvline(x=freqlist[-1], ymax=0.9, color="k", ls="--")
    ax2.set_ylabel("Amplitude [dB]", **_LBL)
    ax2.set_xlabel("Frequency [Hz]", **_LBL)
    ax2.set_xlim(FMIN - 0.01, FMAX + 1)
    ax2.set_ylim(-3, 0.4)
    ax2.set_title("c) Narrow Band Filters", loc="left", **_LBL)
    ax2.text(0.02, 0.95, "Filter Type = " + FILTER_TYPE,
             transform=ax2.transAxes, ha="left", fontsize=fonts - 2)
    ax2.text(0.98, 0.95, "Filter Order = " + str(FILTER_ORDER),
             transform=ax2.transAxes, ha="right", fontsize=fonts - 2)
    if FILTER_TYPE == "cheby1":
        ax2.text(0.5, 0.95, "Ripple = " + str(FILTER_RIPPLE),
                 transform=ax2.transAxes, ha="center", fontsize=fonts - 2)
    fig.tight_layout()
    return fig


# --------------------------------------------------------------------------
def _freq_time_panels(fig, gs, st, NBANDS, freqlist, FREQ_BAND_TYPE,
                      vel_array, baz_array, mdccm_array, t_array,
                      num_compute_list, MDCCM_THRESH, FMIN, FMAX,
                      raster_axes, scatter_axes, color_map="turbo",
                      sig_tau_array=None, sig_raster_ax=None,
                      sig_scatter_ax=None):
    """Shared body of the narrow-band multi-panel figures.

    raster_axes: (ax_mdccm, ax_baz, ax_vel); scatter_axes: (ax_baz, ax_vel).
    Returns the last frequency-scatter handle for colorbar attachment.
    """
    normal_baz = Normalize(0, 360)
    normal_vel = Normalize(0.2, 0.5)
    normal_mdccm = Normalize(0.0, 1.0)
    normal_sig = Normalize(0.0, 5.0)
    cmap_col = plt.get_cmap("jet" if color_map == "jet" else "turbo")
    sc = sc_vel = sc_sig = None

    ax_m, ax_b, ax_v = raster_axes
    ax_sb, ax_sv = scatter_axes

    for b in range(NBANDS):
        fmin_b, fmax_b = _band_edges(freqlist, b, FREQ_BAND_TYPE)
        height = fmax_b - fmin_b
        favg = fmin_b + height / 2

        vel = _clip_vel(_valid(vel_array, b, num_compute_list))
        baz = _valid(baz_array, b, num_compute_list)
        mdccm = _valid(mdccm_array, b, num_compute_list)
        t = _valid(t_array, b, num_compute_list)
        if len(t) == 0:
            continue

        colors_baz = cmap_col(normal_baz(baz))
        colors_vel = cmap_col(normal_vel(vel))
        colors_mdccm = plt.get_cmap("YlGnBu")(normal_mdccm(mdccm))

        good = mdccm > MDCCM_THRESH
        favg_arr = np.full(int(good.sum()), favg)
        sc = ax_sb.scatter(t[good], baz[good], c=favg_arr, edgecolors="k",
                           lw=0.3, cmap="turbo")
        sc.set_clim((FMIN, FMAX))
        sc_vel = ax_sv.scatter(t[good], vel[good], c=favg_arr,
                               edgecolors="k", lw=0.3, cmap="turbo")
        sc_vel.set_clim((FMIN, FMAX))

        above = mdccm >= MDCCM_THRESH
        _draw_rects(ax_m, t, colors_mdccm, fmin_b, height, above)
        _draw_rects(ax_b, t, colors_baz, fmin_b, height, above)
        _draw_rects(ax_v, t, colors_vel, fmin_b, height, above)
        # sub-threshold MdCCM cells at half alpha
        below = ~above
        for jj in np.nonzero(below[:-1])[0]:
            ax_m.add_patch(Rectangle(
                (t[jj], fmin_b), t[jj + 1] - t[jj], height,
                color=colors_mdccm[jj], alpha=0.5,
            ))

        if sig_tau_array is not None:
            sig = _valid(sig_tau_array, b, num_compute_list)
            sig = sig.copy()
            sig[sig >= 5] = 5.1
            colors_sig = plt.get_cmap("YlGnBu_r")(normal_sig(sig))
            if sig_raster_ax is not None:
                _draw_rects(sig_raster_ax, t, colors_sig, fmin_b, height, above)
            if sig_scatter_ax is not None:
                sc_sig = sig_scatter_ax.scatter(
                    t[good], sig[good], c=favg_arr, edgecolors="k", lw=0.3,
                    cmap="turbo",
                )
                sc_sig.set_clim((FMIN, FMAX))

    last_t = _valid(t_array, NBANDS - 1, num_compute_list)
    return sc, sc_vel, sc_sig, last_t, (normal_mdccm, normal_baz, normal_vel,
                                        normal_sig)


def _format_ft_axis(ax, tag, ylabel, t, ylim):
    ax.set_ylabel(ylabel, **_LBL)
    ax.set_xlabel("Time [UTC]", **_LBL)
    ax.set_title(tag, loc="left", **_LBL)
    ax.xaxis_date()
    ax.set_ylim(*ylim)
    ax.set_xlim(t[0], t[-1])


def narrow_band_plot(FMIN, FMAX, st, NBANDS, freqlist, FREQ_BAND_TYPE,
                     vel_array, baz_array, mdccm_array, t_array,
                     num_compute_list, MDCCM_THRESH):
    """Flagship 6-panel narrow-band figure (reference plotting.py:266-476)."""
    fig = plt.figure(figsize=(15, 20))
    gs = gridspec.GridSpec(6, 2, width_ratios=[3, 0.1])

    timevec = st[0].times("matplotlib")
    ax0 = fig.add_subplot(gs[0, 0])
    ax0.plot(timevec, np.asarray(st[0]), "k")
    axes = [fig.add_subplot(gs[i, 0]) for i in range(1, 6)]
    ax1, ax2, ax3, ax4, ax5 = axes

    sc, sc_vel, _, t, norms = _freq_time_panels(
        fig, gs, st, NBANDS, freqlist, FREQ_BAND_TYPE,
        vel_array, baz_array, mdccm_array, t_array, num_compute_list,
        MDCCM_THRESH, FMIN, FMAX,
        raster_axes=(ax1, ax2, ax3), scatter_axes=(ax4, ax5),
        color_map="turbo",
    )
    normal_mdccm, normal_baz, normal_vel, _ = norms

    for caxpos, cmap, norm, label, ticks in (
        (gs[1, 1], "YlGnBu", normal_mdccm, "MdCCM", None),
        (gs[2, 1], "turbo", normal_baz, "Backazimuth [deg]", [0, 90, 180, 270, 360]),
        (gs[3, 1], "turbo", normal_vel, "Trace Velocity [km/s]", None),
    ):
        cax = fig.add_subplot(caxpos)
        cbar.ColorbarBase(cax, cmap=plt.get_cmap(cmap), norm=norm,
                          orientation="vertical",
                          ticks=ticks)
        cax.set_ylabel(label, **_LBL)
    cax = fig.add_subplot(gs[4:6, 1])
    if sc is not None:
        fig.colorbar(sc, cax=cax, orientation="vertical")
    cax.set_ylabel("Frequency [Hz]", **_LBL)

    ax0.xaxis_date()
    ax0.set_xlim(timevec[1], timevec[-1])
    ax0.set_ylabel("Pressure [Pa]", **_LBL)
    ax0.set_xlabel("Time [UTC]", **_LBL)
    ax0.set_title("a)", loc="left", **_LBL)
    _format_ft_axis(ax1, "b)", "Frequency [Hz]", t, (FMIN, FMAX))
    _format_ft_axis(ax2, "c)", "Frequency [Hz]", t, (FMIN, FMAX))
    _format_ft_axis(ax3, "d)", "Frequency [Hz]", t, (FMIN, FMAX))
    _format_ft_axis(ax4, "e)", "Backazimuth [deg]", t, (0, 360))
    _format_ft_axis(ax5, "f)", "Trace Velocity [km/s]", t, (0.2, 0.5))
    fig.tight_layout()
    return fig


def narrow_band_stau_plot(FMIN, FMAX, st, NBANDS, freqlist, FREQ_BAND_TYPE,
                          vel_array, baz_array, mdccm_array, t_array,
                          sig_tau_array, num_compute_list, MDCCM_THRESH,
                          ALPHA):
    """8-panel variant with sigma_tau raster+scatter (reference plotting.py:480-742)."""
    if ALPHA < 1.0:
        print(
            f"You ran LTS with ALPHA = {ALPHA}. It would be better to use "
            '"narrow_band_lts_plot" and "narrow_band_lts_dropped_station_plot".'
        )
    fig = plt.figure(figsize=(15, 20))
    gs = gridspec.GridSpec(8, 2, width_ratios=[3, 0.1])

    timevec = st[0].times("matplotlib")
    ax0 = fig.add_subplot(gs[0, 0])
    ax0.plot(timevec, np.asarray(st[0]), "k")
    axes = [fig.add_subplot(gs[i, 0]) for i in range(1, 8)]
    ax1, ax2, ax3, ax4, ax5, ax6, ax7 = axes

    sc, sc_vel, sc_sig, t, norms = _freq_time_panels(
        fig, gs, st, NBANDS, freqlist, FREQ_BAND_TYPE,
        vel_array, baz_array, mdccm_array, t_array, num_compute_list,
        MDCCM_THRESH, FMIN, FMAX,
        raster_axes=(ax1, ax3, ax4), scatter_axes=(ax6, ax7),
        color_map="jet",
        sig_tau_array=sig_tau_array,
        sig_raster_ax=(ax2 if ALPHA == 1.0 else None),
        sig_scatter_ax=(ax5 if ALPHA == 1.0 else None),
    )
    normal_mdccm, normal_baz, normal_vel, normal_sig = norms

    for caxpos, cmap, norm, label, ticks in (
        (gs[1, 1], "YlGnBu", normal_mdccm, "MdCCM", None),
        (gs[2, 1], "YlGnBu_r", normal_sig, "Sigma Tau\n" r"($\sigma_\tau$)", None),
        (gs[3, 1], "turbo", normal_baz, "Backazimuth\n[deg]", [0, 90, 180, 270, 360]),
        (gs[4, 1], "turbo", normal_vel, "Trace Velocity\n[km/s]", None),
    ):
        cax = fig.add_subplot(caxpos)
        cbar.ColorbarBase(cax, cmap=plt.get_cmap(cmap), norm=norm,
                          orientation="vertical", ticks=ticks)
        cax.set_ylabel(label, **_LBL)
    cax = fig.add_subplot(gs[5:8, 1])
    if sc is not None:
        fig.colorbar(sc, cax=cax, orientation="vertical")
    cax.set_ylabel("Frequency [Hz]", **_LBL)

    ax0.xaxis_date()
    ax0.set_xlim(timevec[1], timevec[-1])
    ax0.set_ylabel("Pressure [Pa]", **_LBL)
    ax0.set_xlabel("Time [UTC]", **_LBL)
    ax0.set_title("a)", loc="left", **_LBL)
    _format_ft_axis(ax1, "b)", "Frequency [Hz]", t, (FMIN, FMAX))
    _format_ft_axis(ax2, "c)", "Frequency [Hz]", t, (FMIN, FMAX))
    _format_ft_axis(ax3, "d)", "Frequency [Hz]", t, (FMIN, FMAX))
    _format_ft_axis(ax4, "e)", "Frequency [Hz]", t, (FMIN, FMAX))
    _format_ft_axis(ax5, "f)", "Sigma Tau\n" r"($\sigma_\tau$)", t, (-0.5, 5))
    _format_ft_axis(ax6, "g)", "Backazimuth\n[deg]", t, (0, 360))
    ax6.set_yticks([0, 90, 180, 270, 360])
    _format_ft_axis(ax7, "h)", "Trace Velocity\n[km/s]", t, (0.2, 0.5))
    fig.tight_layout()
    return fig


def narrow_band_lts_plot(FMIN, FMAX, st, NBANDS, freqlist, FREQ_BAND_TYPE,
                         vel_array, baz_array, mdccm_array, t_array, stdict,
                         num_compute_list, MDCCM_THRESH, ALPHA):
    """7-panel LTS variant with dropped-element scatter (reference plotting.py:750-1035)."""
    if ALPHA == 1.0:
        print('You used ALPHA = 1.0. It would be better to use "narrow_band_stau_plot".')
    fig = plt.figure(figsize=(15, 20))
    gs = gridspec.GridSpec(7, 2, width_ratios=[3, 0.1])

    timevec = st[0].times("matplotlib")
    ax0 = fig.add_subplot(gs[0, 0])
    ax0.plot(timevec, np.asarray(st[0]), "k")
    axes = [fig.add_subplot(gs[i, 0]) for i in range(1, 7)]
    ax1, ax2, ax3, ax4, ax5, ax6 = axes

    sc, sc_vel, _, t, norms = _freq_time_panels(
        fig, gs, st, NBANDS, freqlist, FREQ_BAND_TYPE,
        vel_array, baz_array, mdccm_array, t_array, num_compute_list,
        MDCCM_THRESH, FMIN, FMAX,
        raster_axes=(ax1, ax2, ax3), scatter_axes=(ax4, ax5),
        color_map="jet",
    )
    normal_mdccm, normal_baz, normal_vel, _ = norms

    # dropped-element panel
    ax6.set_ylabel("Element [#]", **_LBL)
    ax6.set_xlabel("Time [UTC]", **_LBL)
    ax6.xaxis_date()
    ax6.set_title("g)", loc="left", **_LBL)
    sc2 = None
    if ALPHA < 1.0 and stdict is not None:
        n = stdict["size"]
        cm2 = plt.get_cmap("binary", n - 1)
        ax6.set_ylim(0.5, n + 0.5)
        ax6.set_xlim(t[0], t[-1])
        for b in range(NBANDS):
            bd = _stdict_band(stdict, b)
            bd.pop("size", None)
            mdccm = _valid(mdccm_array, b, num_compute_list)
            tb = _valid(t_array, b, num_compute_list)
            t_round = np.round(tb, 7)
            for key, elements in bd.items():
                tstamp = float(key)
                hits = np.nonzero(np.isclose(t_round, tstamp, rtol=0, atol=5e-8))[0]
                if len(hits) == 0:
                    hits = np.nonzero(tb == tstamp)[0]
                if len(hits) == 0:
                    continue
                ind = int(hits[0])
                if mdccm[ind] < MDCCM_THRESH or len(elements) == 0:
                    continue
                z = Counter(list(elements))
                keys = np.array(list(z.keys()))
                vals = np.array(list(z.values()))
                pts = np.full(len(keys), tstamp)
                sc2 = ax6.scatter(pts, keys, c=vals, edgecolors="k", lw=0.1,
                                  cmap=cm2, vmin=0.5, vmax=n - 0.5)
        if sc2 is not None:
            cax = fig.add_subplot(gs[6, 1])
            fig.colorbar(sc2, orientation="vertical", cax=cax)
            cax.set_ylabel("# of Flagged\nElement Pairs", **_LBL)

    for caxpos, cmap, norm, label, ticks in (
        (gs[1, 1], "YlGnBu", normal_mdccm, "MdCCM", None),
        (gs[2, 1], "turbo", normal_baz, "Backazimuth\n[deg]", [0, 90, 180, 270, 360]),
        (gs[3, 1], "turbo", normal_vel, "Trace Velocity\n[km/s]", None),
    ):
        cax = fig.add_subplot(caxpos)
        cbar.ColorbarBase(cax, cmap=plt.get_cmap(cmap), norm=norm,
                          orientation="vertical", ticks=ticks)
        cax.set_ylabel(label, **_LBL)
    cax = fig.add_subplot(gs[4:6, 1])
    if sc is not None:
        fig.colorbar(sc, cax=cax, orientation="vertical")
    cax.set_ylabel("Frequency [Hz]", **_LBL)

    ax0.xaxis_date()
    ax0.set_xlim(timevec[1], timevec[-1])
    ax0.set_ylabel("Pressure [Pa]", **_LBL)
    ax0.set_xlabel("Time [UTC]", **_LBL)
    ax0.set_title("a)", loc="left", **_LBL)
    _format_ft_axis(ax1, "b)", "Frequency [Hz]", t, (FMIN, FMAX))
    _format_ft_axis(ax2, "c)", "Frequency [Hz]", t, (FMIN, FMAX))
    _format_ft_axis(ax3, "d)", "Frequency [Hz]", t, (FMIN, FMAX))
    _format_ft_axis(ax4, "e)", "Backazimuth\n[deg]", t, (0, 360))
    ax4.set_yticks([0, 90, 180, 270, 360])
    _format_ft_axis(ax5, "f)", "Trace Velocity\n[km/s]", t, (0.2, 0.5))
    fig.tight_layout()
    return fig


def narrow_band_lts_dropped_station_plot(FMIN, FMAX, st, NBANDS, freqlist,
                                         FREQ_BAND_TYPE, vel_array, baz_array,
                                         mdccm_array, t_array, stdict,
                                         num_compute_list, MDCCM_THRESH):
    """Per-element frequency-time flag rasters (reference plotting.py:1042-1170)."""
    num_sta = stdict["size"]
    cm2 = plt.get_cmap("binary", num_sta - 1)
    normal_element = Normalize(0.5, num_sta - 0.5)

    fig = plt.figure(figsize=(15, 20))
    gs = gridspec.GridSpec(num_sta, 2, width_ratios=[3, 0.1])
    el_axes = [fig.add_subplot(gs[k, 0]) for k in range(num_sta)]

    t_last = _valid(t_array, NBANDS - 1, num_compute_list)
    for k, ax in enumerate(el_axes):
        ax.scatter(np.array([t_last[0], t_last[-1]]), np.array([0.01, 0.01]), c="w")
        ax.set_xlabel("Time [UTC]", **_LBL)
        ax.set_xlim(t_last[0], t_last[-1])
        ax.xaxis_date()
        ax.set_ylabel("Frequency [Hz]", **_LBL)
        ax.set_ylim(FMIN, FMAX)
        ax.set_title("Element " + str(k + 1), loc="left", **_LBL)

    for b in range(NBANDS):
        fmin_b, fmax_b = _band_edges(freqlist, b, FREQ_BAND_TYPE)
        height = fmax_b - fmin_b
        mdccm = _valid(mdccm_array, b, num_compute_list)
        tb = _valid(t_array, b, num_compute_list)
        t_round = np.round(tb, 7)
        bd = _stdict_band(stdict, b)
        bd.pop("size", None)
        for key, elements in bd.items():
            tstamp = float(key)
            hits = np.nonzero(np.isclose(t_round, tstamp, rtol=0, atol=5e-8))[0]
            if len(hits) == 0:
                hits = np.nonzero(tb == tstamp)[0]
            if len(hits) == 0:
                continue
            ind = int(hits[0])
            if mdccm[ind] < MDCCM_THRESH or len(elements) == 0:
                continue
            z = Counter(list(elements))
            for el, count in z.items():
                ax = el_axes[int(el) - 1]
                if ind == len(tb) - 1:
                    width = tb[ind] - tb[ind - 1]
                else:
                    width = tb[ind + 1] - tb[ind]
                ax.add_patch(Rectangle(
                    (tstamp, fmin_b), width, height,
                    facecolor=cm2(count - 1), edgecolor="k", linewidth=0.1,
                ))

    axc = fig.add_subplot(gs[0:num_sta, 1])
    cbar.ColorbarBase(axc, cmap=cm2, norm=normal_element)
    axc.set_ylabel("# of Flagged Element Pairs", **_LBL)
    fig.tight_layout()
    return fig


def monitoring_uncertainty_plot(FMIN, FMAX, NBANDS, freqlist, vel_uncert,
                                baz_uncert, mdccm_array, t_array,
                                num_compute_list, MDCCM_THRESH,
                                flags=None):
    """Long-duration uncertainty (and LTS flag-fraction) rasters.

    Beyond-reference companion to `baz_freq_plot` (same long-duration
    semantics: per-band valid prefixes, MdCCM gating): scatters the
    back-azimuth and velocity confidence half-widths of every confident
    window against time, colored by band center frequency, plus — when an
    LTS ``flags`` tensor ``(B, width, P)`` is given (`StreamingMonitor.
    read_all(extras=True)`) — the flagged-pair fraction per window.  The
    uncertainty quantities live only in the monitor's .npz sidecars (the
    reference TSV format cannot carry them, reference helpers.py:161).
    """
    n_panels = 3 if flags is not None else 2
    fig = plt.figure(figsize=(15, 3.5 * n_panels))
    gs = gridspec.GridSpec(n_panels, 2, width_ratios=[3, 0.1])
    axes = [fig.add_subplot(gs[i, 0]) for i in range(n_panels)]

    sc = None
    t_last = None
    for b in range(NBANDS):
        fmin_b = float(freqlist[b])
        fmax_b = float(freqlist[b + 1])
        favg = fmin_b + (fmax_b - fmin_b) / 2
        mdccm = _valid(mdccm_array, b, num_compute_list)
        bu = _valid(baz_uncert, b, num_compute_list)
        vu = _valid(vel_uncert, b, num_compute_list)
        t = _valid(t_array, b, num_compute_list)
        sel = (mdccm > MDCCM_THRESH) & np.isfinite(bu) & np.isfinite(vu)
        c = np.full(int(sel.sum()), favg)
        sc = axes[0].scatter(t[sel], bu[sel], s=5, c=c,
                             edgecolors="none", cmap="turbo")
        sc.set_clim((FMIN, FMAX))
        sc2 = axes[1].scatter(t[sel], vu[sel], s=5, c=c,
                              edgecolors="none", cmap="turbo")
        sc2.set_clim((FMIN, FMAX))
        if flags is not None:
            n = int(num_compute_list[b])
            frac = np.asarray(flags[b, :n], dtype=float).mean(axis=-1)
            sc3 = axes[2].scatter(t[sel], frac[sel], s=5, c=c,
                                  edgecolors="none", cmap="turbo")
            sc3.set_clim((FMIN, FMAX))
        if len(t):
            t_last = t

    cax = fig.add_subplot(gs[:, 1])
    if sc is not None:
        fig.colorbar(sc, cax=cax, orientation="vertical")
    cax.set_ylabel("Frequency [Hz]", **_LBL)

    axes[0].set_ylabel("Baz CI [deg]", **_LBL)
    axes[1].set_ylabel("Vel CI [km/s]", **_LBL)
    if flags is not None:
        axes[2].set_ylabel("Flagged-Pair Fraction", **_LBL)
        axes[2].set_ylim(-0.02, 1.0)
    axes[-1].set_xlabel("Time", **_LBL)
    for ax in axes:
        ax.xaxis_date()
        if t_last is not None and len(t_last):
            ax.set_xlim(t_last[0], t_last[-1])
    fig.tight_layout()
    return fig


def baz_freq_plot(FMIN, FMAX, NBANDS, freqlist, vel_array, baz_array,
                  mdccm_array, t_array, num_compute_list, MDCCM_THRESH):
    """Long-duration back-azimuth vs time, colored by frequency
    (reference plotting.py:1179-1270; the weeks/months monitoring figure)."""
    fig = plt.figure(figsize=(15, 7))
    gs = gridspec.GridSpec(1, 2, width_ratios=[3, 0.1])
    ax1 = fig.add_subplot(gs[0, 0])

    sc = None
    t = None
    for b in range(NBANDS):
        fmin_b = float(freqlist[b])
        fmax_b = float(freqlist[b + 1])
        favg = fmin_b + (fmax_b - fmin_b) / 2
        vel = _valid(vel_array, b, num_compute_list)
        baz = _valid(baz_array, b, num_compute_list)
        mdccm = _valid(mdccm_array, b, num_compute_list)
        t = _valid(t_array, b, num_compute_list)
        good = mdccm > MDCCM_THRESH
        phys = (vel > 0.25) & (vel < 0.45)
        sel = good & phys
        sc = ax1.scatter(t[sel], baz[sel], s=5,
                         c=np.full(int(sel.sum()), favg),
                         edgecolors="none", cmap="turbo")
        sc.set_clim((FMIN, FMAX))

    cax = fig.add_subplot(gs[0, 1])
    if sc is not None:
        fig.colorbar(sc, cax=cax, orientation="vertical")
    cax.set_ylabel("Frequency [Hz]", **_LBL)

    ax1.set_ylabel("Backazimuth [deg]", **_LBL)
    ax1.set_xlabel("Time", **_LBL)
    ax1.xaxis_date()
    ax1.set_ylim(0, 360)
    if t is not None and len(t):
        ax1.set_xlim(t[0], t[-1])
    fig.tight_layout()
    return fig
