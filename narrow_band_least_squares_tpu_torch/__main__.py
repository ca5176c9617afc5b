"""Command-line front-end.

The port's counterpart of ``python -m narrow_band_least_squares_tpu``: the
same commands, arguments, config files and outputs, on the card unless
``--device cpu`` is given:

    python -m narrow_band_least_squares_tpu_torch run --config cfg.json --out out/
    python -m narrow_band_least_squares_tpu_torch run --synthetic --out out/
    python -m narrow_band_least_squares_tpu_torch monitor --config cfg.json \
        --data stream.npz --segment-s 1200 --out mon/
    python -m narrow_band_least_squares_tpu_torch fetch --config cfg.json --out event.npz
    python -m narrow_band_least_squares_tpu_torch defaults > cfg.json

`run` executes broadband + narrow-band processing and writes the TSV
results, the config it used, the full figure set and a JSON summary with
the phase times; `monitor` runs the segmented checkpoint/resume pipeline.
Without CUDA, `run` and `monitor` raise unless given ``--device cpu``.
``--subsample-delays`` (`run` and `monitor`, the port's own flag: the JAX
package's config has no such field) refines every delay by the parabola
through its peak's neighbours, with ``xcorr_method`` 'mxu'.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np


def _read_data_file(path, coords_path=None):
    """ArrayStream from an .npz snapshot or a miniSEED file (native codec)."""
    from narrow_band_least_squares_tpu_torch.io.stream import ArrayStream

    if path.endswith((".mseed", ".ms", ".msd", ".seed")):
        from narrow_band_least_squares_tpu_torch.io.ingest import (
            mseed_to_stream, read_mseed,
        )
        if not coords_path:
            raise SystemExit(
                "miniSEED input needs --coords (JSON: {sid: [lat, lon]})"
            )
        with open(coords_path) as f:
            coords = {k: tuple(v) for k, v in json.load(f).items()}
        return mseed_to_stream(read_mseed(path), coords)
    return ArrayStream.load_npz(path)


def _load_stream(args, cfg):
    from narrow_band_least_squares_tpu_torch.io.stream import gather_waveforms
    from narrow_band_least_squares_tpu_torch.io.synthetic import synthetic_plane_wave
    from narrow_band_least_squares_tpu_torch.utils.timeutils import parse_utc

    if args.data:
        return _read_data_file(args.data, getattr(args, "coords", None))
    if args.synthetic:
        dur = parse_utc(cfg.END) - parse_utc(cfg.START)
        return synthetic_plane_wave(
            nchans=8, duration_s=max(dur, 600.0), fs=20.0,
            baz_deg=230.0, trace_vel_kms=0.34,
            start_epoch=parse_utc(cfg.START), seed=42,
        )
    return gather_waveforms(
        cfg.SOURCE, cfg.NETWORK, cfg.STATION, cfg.LOCATION, cfg.CHANNEL,
        cfg.START, cfg.END, remove_response=True,
        cache=os.path.join(args.out, "event_cache.npz"),
    )


def _load_config(args):
    from narrow_band_least_squares_tpu_torch.config import NBLSConfig

    return NBLSConfig.from_json(args.config) if args.config else NBLSConfig()


def _overrides(args, cfg):
    """The config's pipeline options, with ``subsample_delays`` when the
    command line asks for it."""
    out = cfg.perf_overrides()
    if getattr(args, "subsample_delays", False):
        out["subsample_delays"] = True
    return out


def cmd_run(args):
    from narrow_band_least_squares_tpu_torch import api
    from narrow_band_least_squares_tpu_torch.utils.device import resolve_device
    from narrow_band_least_squares_tpu_torch.utils.profiling import PhaseTimers

    dev = resolve_device(args.device)
    cfg = _load_config(args)
    os.makedirs(args.out, exist_ok=True)
    api.set_performance_defaults(**_overrides(args, cfg))
    st = _load_stream(args, cfg)
    timers = PhaseTimers()

    with timers.phase("broadband"):
        stf, Fs, sos = api.filter_data(
            st, cfg.FILTER_TYPE, cfg.FMIN, cfg.FMAX,
            cfg.FILTER_ORDER, cfg.FILTER_RIPPLE, device=dev,
        )
        bb = api.ltsva(
            stf, st.latitudes, st.longitudes, cfg.WINLEN, cfg.WINOVER,
            cfg.ALPHA, device=dev,
        )

    with timers.phase("narrowband"):
        freqlist, nbands, fmax = api.get_freqlist(
            cfg.FMIN, cfg.FMAX, cfg.FREQ_BAND_TYPE, cfg.NBANDS
        )
        winlens = api.get_winlenlist(
            cfg.WINDOW_LENGTH_TYPE, nbands, cfg.WINLEN,
            cfg.WINLEN_1, cfg.WINLEN_X,
        )
        fr = np.logspace(-2, np.log10(st.fs / 2), 1000)
        out = api.narrow_band_least_squares(
            winlens, cfg.WINOVER, cfg.ALPHA, st, st.latitudes, st.longitudes,
            nbands, None, None, freqlist, cfg.FREQ_BAND_TYPE, fr,
            cfg.FILTER_TYPE, cfg.FILTER_ORDER, cfg.FILTER_RIPPLE, device=dev,
        )
    (vel_a, baz_a, mdccm_a, t_a, stdict_all, sig_a, num, w_a, h_a) = out

    with timers.phase("persist"):
        api.write_txtfile(
            args.out, "narrow_band_results", vel_a, baz_a, mdccm_a, t_a,
            freqlist, num,
        )
        cfg.to_json(os.path.join(args.out, "config_used.json"))

    if not args.no_figures:
        with timers.phase("figures"):
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
            from narrow_band_least_squares_tpu_torch import plotting as P

            rij = api.get_rij(st.latitudes, st.longitudes, st.nchans)
            figs = {
                "Broadband_Least_Squares": P.broadband_plot(
                    stf, bb[0], bb[1], bb[3], bb[2], cfg.MDCCM_THRESH,
                    cfg.ALPHA, bb[4], bb[5],
                ),
                "Narrow_Band_Least_Squares": P.narrow_band_plot(
                    cfg.FMIN, fmax, stf, nbands, freqlist,
                    cfg.FREQ_BAND_TYPE, vel_a, baz_a, mdccm_a, t_a, num,
                    cfg.MDCCM_THRESH,
                ),
                "Narrow_Band_Processing_Parameters":
                    P.narrow_band_processing_parameters_plot(
                        rij, cfg.FREQ_BAND_TYPE, freqlist, winlens, nbands,
                        cfg.FMIN, fmax, w_a, h_a, cfg.FILTER_TYPE,
                        cfg.FILTER_ORDER, cfg.FILTER_RIPPLE,
                    ),
            }
            if cfg.ALPHA == 1.0:
                figs["Narrow_Band_Least_Squares_Sigma_Tau"] = (
                    P.narrow_band_stau_plot(
                        cfg.FMIN, fmax, stf, nbands, freqlist,
                        cfg.FREQ_BAND_TYPE, vel_a, baz_a, mdccm_a, t_a,
                        sig_a, num, cfg.MDCCM_THRESH, cfg.ALPHA,
                    )
                )
            else:
                figs["Narrow_Band_Least_Squares_LTS"] = P.narrow_band_lts_plot(
                    cfg.FMIN, fmax, stf, nbands, freqlist,
                    cfg.FREQ_BAND_TYPE, vel_a, baz_a, mdccm_a, t_a,
                    stdict_all, num, cfg.MDCCM_THRESH, cfg.ALPHA,
                )
                figs["Narrow_Band_Least_Squares_LTS_Dropped_Stations"] = (
                    P.narrow_band_lts_dropped_station_plot(
                        cfg.FMIN, fmax, stf, nbands, freqlist,
                        cfg.FREQ_BAND_TYPE, vel_a, baz_a, mdccm_a, t_a,
                        stdict_all, num, cfg.MDCCM_THRESH,
                    )
                )
            for name, fig in figs.items():
                fig.savefig(
                    os.path.join(args.out, name + cfg.file_type),
                    dpi=cfg.dpi_num,
                )
                plt.close(fig)

    timers.log()
    good = mdccm_a > cfg.MDCCM_THRESH
    summary = {
        "bands": nbands,
        "num_compute_list": [int(v) for v in num],
        "windows_above_threshold": int(good.sum()),
        "median_baz_deg": float(np.median(baz_a[good])) if good.any() else None,
        "median_vel_kms": float(np.median(vel_a[good])) if good.any() else None,
        "out_dir": args.out,
        "phases": timers.report(),
    }
    print(json.dumps(summary, indent=2))


def cmd_monitor(args):
    from narrow_band_least_squares_tpu_torch.models.streaming import StreamingMonitor
    from narrow_band_least_squares_tpu_torch.utils.device import resolve_device
    from narrow_band_least_squares_tpu_torch.utils.geometry import get_rij
    from narrow_band_least_squares_tpu_torch.utils.plan import (
        get_freqlist, get_winlenlist, make_plan,
    )

    dev = resolve_device(args.device)
    cfg = _load_config(args)
    st = _read_data_file(args.data, getattr(args, "coords", None))
    freqlist, nbands, _ = get_freqlist(
        cfg.FMIN, cfg.FMAX, cfg.FREQ_BAND_TYPE, cfg.NBANDS
    )
    winlens = get_winlenlist(
        cfg.WINDOW_LENGTH_TYPE, nbands, cfg.WINLEN, cfg.WINLEN_1, cfg.WINLEN_X
    )
    plan = make_plan(
        freqlist, cfg.FREQ_BAND_TYPE, winlens, cfg.WINOVER,
        int(args.segment_s * st.fs), st.fs,
    )
    rij = get_rij(st.latitudes, st.longitudes, st.nchans)
    with StreamingMonitor(
        plan, rij, args.out, freqlist,
        filter_type=cfg.FILTER_TYPE, filter_order=cfg.FILTER_ORDER,
        filter_ripple=cfg.FILTER_RIPPLE, alpha=cfg.ALPHA,
        dispatch_segments=getattr(args, "dispatch_segments", 4),
        device=dev, **_overrides(args, cfg),
    ) as mon:
        recs = mon.process(st, resume=not args.no_resume)
    print(json.dumps({
        "segments_processed": len(recs),
        "out_dir": args.out,
    }))


def cmd_defaults(args):
    from narrow_band_least_squares_tpu_torch.config import NBLSConfig

    print(json.dumps(NBLSConfig().to_dict(), indent=2))


def cmd_fetch(args):
    """Fetch waveforms (FDSN, response removed) into an ArrayStream .npz.

    The reference's L0 step (``gather_waveforms`` at example.py:91) as a
    standalone command, so long runs can separate acquisition from compute:
        ... fetch --config cfg.json --out event.npz
        ... run --config cfg.json --data event.npz
    """
    from narrow_band_least_squares_tpu_torch.io.stream import gather_waveforms

    cfg = _load_config(args)
    st = gather_waveforms(
        cfg.SOURCE, cfg.NETWORK, cfg.STATION, cfg.LOCATION, cfg.CHANNEL,
        cfg.START, cfg.END,
        remove_response=not args.raw,
        cache=args.out,
    )
    print(json.dumps({
        "out": args.out, "nchans": st.nchans, "npts": st.npts,
        "fs": st.fs, "ids": list(st.ids),
    }))


def main(argv=None):
    ap = argparse.ArgumentParser(prog="narrow_band_least_squares_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)
    device_help = ("'cuda' (the default; raises without CUDA) or 'cpu' (the "
                   "kernels' plain PyTorch versions)")
    subsample_help = ("refine each delay by the parabola through the "
                      "correlation peak and its neighbours (xcorr_method 'mxu')")

    p_run = sub.add_parser("run", help="broadband + narrow-band processing")
    p_run.add_argument("--config", help="NBLSConfig JSON (defaults otherwise)")
    p_run.add_argument("--out", default="nbls_out")
    p_run.add_argument("--data", help="ArrayStream .npz or miniSEED input")
    p_run.add_argument("--coords", help="JSON {sid: [lat, lon]} for miniSEED")
    p_run.add_argument("--synthetic", action="store_true",
                       help="synthesize the canonical event (offline)")
    p_run.add_argument("--no-figures", action="store_true")
    p_run.add_argument("--device", default="cuda", help=device_help)
    p_run.add_argument("--subsample-delays", action="store_true", help=subsample_help)
    p_run.set_defaults(fn=cmd_run)

    p_mon = sub.add_parser("monitor", help="segmented checkpoint/resume run")
    p_mon.add_argument("--config")
    p_mon.add_argument("--data", required=True,
                       help="ArrayStream .npz or miniSEED input")
    p_mon.add_argument("--coords", help="JSON {sid: [lat, lon]} for miniSEED")
    p_mon.add_argument("--segment-s", type=float, default=1200.0)
    p_mon.add_argument("--out", default="nbls_monitor")
    p_mon.add_argument("--no-resume", action="store_true")
    p_mon.add_argument("--dispatch-segments", type=int, default=4,
                       help="segments batched per device dispatch "
                            "(amortizes dispatch round trips; higher = "
                            "more throughput, more result latency)")
    p_mon.add_argument("--device", default="cuda", help=device_help)
    p_mon.add_argument("--subsample-delays", action="store_true", help=subsample_help)
    p_mon.set_defaults(fn=cmd_monitor)

    p_def = sub.add_parser("defaults", help="print a default config JSON")
    p_def.set_defaults(fn=cmd_defaults)

    p_fetch = sub.add_parser(
        "fetch", help="fetch waveforms (FDSN, response removed) to .npz"
    )
    p_fetch.add_argument("--config", help="NBLSConfig JSON (defaults otherwise)")
    p_fetch.add_argument("--out", default="event_cache.npz")
    p_fetch.add_argument("--raw", action="store_true",
                         help="skip instrument-response removal")
    p_fetch.set_defaults(fn=cmd_fetch)

    args = ap.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
