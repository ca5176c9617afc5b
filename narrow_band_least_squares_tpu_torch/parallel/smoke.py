"""One rank of a multi-process run of the sharded pipeline.

Run one process per rank with the variables ``torchrun`` sets
(``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``)::

    torchrun --nproc-per-node=4 -m narrow_band_least_squares_tpu_torch.parallel.smoke \\
        --mesh-time 2 --mesh-band 2 --device cpu --out /tmp/smoke.npz

or start the processes yourself with those variables set.  Each rank
builds the same seeded input, runs `ShardedNarrowBandPipeline.run` on the
(time, band) mesh (the halo crosses process boundaries on the time axis,
the band shards' rows on the band axis) and holds it against
`run_reference_sequential` on its own device: bit for bit with 'fused' at
one band shard, within 1e-5 otherwise, LTS flags equal on every window
whose delays are bit-identical; and against the synthetic wave's truth.
``--monitor-dir`` runs `StreamingMonitor` instead (rank 0 persists, a
second pass resumes to nothing, a deleted segment is redone alone);
``--multiarray`` runs `MultiArrayPipeline` on the mesh against each array
alone.  Every rank prints one ``NBLS_SMOKE_RANK {json}`` line (launches
per kernel route, wall time, halo and gather bytes, host copies under
gloo) and ``NBLS_SMOKE_OK`` when every check passed; rank 0 writes
``--out`` (an npz of the assembled outputs) for a caller to compare.  A
failed check exits non-zero.

Workloads: ``small`` (4 elements at 10 Hz, 1600 s in 200 s segments, 4
log bands over 0.2-1.6 Hz: the CPU tests'), ``canonical`` (8 elements at
20 Hz, 6 h in 1200 s segments, 8 log bands over 0.1-5 Hz, adaptive
50/60/30 s windows: the monitor example's) and ``dense50`` (the same with
50 bands).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

WORKLOADS = {
    "small": dict(stream=dict(nchans=4, duration_s=1600.0, fs=10.0, baz_deg=310.0,
                              trace_vel_kms=0.32, f0=0.6, bandwidth=0.8, snr=8.0,
                              seed=21),
                  fmin=0.2, fmax=1.6, nbands=4, winlens=(30, 40, 20), segment_s=200.0,
                  outlier=None),
    "canonical": dict(stream=dict(nchans=8, duration_s=6 * 3600.0, fs=20.0,
                                  baz_deg=230.0, trace_vel_kms=0.34, f0=0.8,
                                  bandwidth=1.4, snr=6.0, seed=42),
                      fmin=0.1, fmax=5.0, nbands=8, winlens=(50, 60, 30),
                      segment_s=1200.0, outlier=2),
}
WORKLOADS["dense50"] = dict(WORKLOADS["canonical"], nbands=50)
TOL = 1e-5          # against the sequential oracle where not bit for bit
SAME_MIN = 0.99     # share of LTS windows whose delays must be bit-identical
PACK_KEYS = ("vel", "baz", "mdccm", "sig_tau", "vel_uncert", "baz_uncert")


class Failure(Exception):
    pass


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise Failure(msg)


def inputs(workload: str, alpha: float = 1.0, hours: float = 0.0):
    """(stream, plan, rij, freqlist) of a workload; ``hours`` cuts the
    stream's duration."""
    from narrow_band_least_squares_tpu_torch.io import synthetic_plane_wave
    from narrow_band_least_squares_tpu_torch.utils import (
        get_freqlist, get_rij, get_winlenlist, make_plan,
    )

    w = WORKLOADS[workload]
    kw = dict(w["stream"])
    if hours:
        kw["duration_s"] = hours * 3600.0
    lts_outlier = alpha < 1 and w["outlier"] is not None
    st = synthetic_plane_wave(**kw, outlier_channels=(w["outlier"],) if lts_outlier else ())
    freqlist, nbands, _ = get_freqlist(w["fmin"], w["fmax"], "log", w["nbands"])
    winlens = get_winlenlist("adaptive", nbands, *w["winlens"])
    plan = make_plan(freqlist, "log", winlens, 0.5, int(w["segment_s"] * st.fs), st.fs)
    return st, plan, get_rij(st.latitudes, st.longitudes, st.nchans), freqlist


def multiarray_inputs(workload: str):
    """Four arrays of the workload's plan: ``small`` the CPU tests' (4
    elements, 240 s, baz 45-315), ``canonical`` 8 elements for 1200 s with
    baz 200-230 (the JAX package's ``benchmarks/scaling.py`` arrays)."""
    from narrow_band_least_squares_tpu_torch.io import synthetic_plane_wave
    from narrow_band_least_squares_tpu_torch.utils import (
        get_freqlist, get_rij, get_winlenlist, make_plan,
    )

    if workload == "small":
        streams = [synthetic_plane_wave(
            nchans=4, duration_s=240.0, fs=10.0, baz_deg=45.0 + 90.0 * k,
            trace_vel_kms=0.30 + 0.02 * k, f0=0.6, bandwidth=0.8, snr=10.0,
            seed=100 + k) for k in range(4)]
        freqlist, nbands, _ = get_freqlist(0.3, 1.5, "log", 2)
        winlens = get_winlenlist("constant", nbands, 30, 0, 0)
        truth = [45.0 + 90.0 * k for k in range(4)]
    else:
        truth = [200.0, 210.0, 220.0, 230.0]
        streams = [synthetic_plane_wave(nchans=8, duration_s=1200.0, fs=20.0,
                                        baz_deg=baz, trace_vel_kms=0.34, seed=42 + k)
                   for k, baz in enumerate(truth)]
        freqlist, nbands, _ = get_freqlist(0.1, 5.0, "log", 8)
        winlens = get_winlenlist("adaptive", nbands, 50, 60, 30)
    plan = make_plan(freqlist, "log", winlens, 0.5, streams[0].npts, streams[0].fs)
    rijs = [get_rij(s.latitudes, s.longitudes, s.nchans) for s in streams]
    return plan, rijs, np.stack([s.data for s in streams]), truth


def baz_error(baz: np.ndarray, truth: float) -> float:
    return float(np.median(np.abs((baz - truth + 180.0) % 360.0 - 180.0)))


def launches():
    """Launches by route: icorr_peak fp32 / tensor cores, fused_xcorr_bucket
    fp32 / tensor cores."""
    from narrow_band_least_squares_tpu_torch.ops.kernels import fused_xcorr as FX
    from narrow_band_least_squares_tpu_torch.ops.kernels import xcorr_peak as XP

    return {"icorr_peak": XP.launches, "icorr_peak_tc": XP.launches_tc,
            "fused_xcorr_bucket": FX.launches, "fused_xcorr_bucket_tc": FX.launches_tc}


def zero_launches() -> None:
    from narrow_band_least_squares_tpu_torch.ops.kernels import fused_xcorr as FX
    from narrow_band_least_squares_tpu_torch.ops.kernels import xcorr_peak as XP

    XP.launches = XP.launches_tc = FX.launches = FX.launches_tc = 0


def synchronize(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


class DelayRecorder:
    """While installed (``with``), records the delays (B, Wmax, P) every
    OLS or LTS solve of the port receives, in call order, as numpy."""

    def __enter__(self):
        from narrow_band_least_squares_tpu_torch.ops import lts as LTS
        from narrow_band_least_squares_tpu_torch.ops import solve as SOLVE

        self.taus = []
        self._real = [(LTS, "lts_solve", LTS.lts_solve),
                      (SOLVE, "ols_solve", SOLVE.ols_solve)]

        def wrap(fn):
            def rec(tau, *args, **kw):
                self.taus.append(tau.detach().cpu().numpy().copy())
                return fn(tau, *args, **kw)
            return rec

        for mod, name, fn in self._real:
            setattr(mod, name, wrap(fn))
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self._real:
            setattr(mod, name, fn)


def buckets(pipe) -> int:
    """Lag searches a rank launches per dispatch: one per (slot) bucket, one
    over the global grid with 'mxu', none with the FFT."""
    if pipe._mode == "bucket":
        return len(pipe._slot_buckets)
    if pipe._mode == "core" and pipe.base.bucket_bands:
        return len(pipe.base._buckets)
    return int(pipe.base.xcorr_method in ("mxu", "pallas"))


def run_pipeline(args, mesh, stats) -> dict:
    """`run` against `run_reference_sequential` (on rank 0, which holds the
    assembled result) and the truth."""
    import torch
    from narrow_band_least_squares_tpu_torch.parallel import ShardedNarrowBandPipeline

    st, plan, rij, _ = inputs(args.workload, args.alpha, args.hours)
    pipe = ShardedNarrowBandPipeline(
        plan, rij, mesh, filter_type="cheby1", alpha=args.alpha,
        xcorr_method=args.xcorr_method, device=args.device)
    check(pipe.halo > 0, "the causal filter must need a halo")
    segs = pipe.segment_stream(st.data)
    pipe.run(segs)                                         # warm-up
    mesh.barrier()
    mesh.reset_stats()
    zero_launches()
    with DelayRecorder() as rec:
        t0 = time.perf_counter()
        out = pipe.run(segs)
        synchronize(args.device)
        stats["wall_s"] = time.perf_counter() - t0
    stats["launches"] = launches()
    st_ = mesh.stats
    stats.update(halo_bytes=st_.halo_bytes, gather_bytes=st_.gather_bytes,
                 broadcast_bytes=st_.broadcast_bytes, host_copy_kinds=sorted(st_.kinds),
                 host_copy_bytes=st_.host_copy_bytes, host_copy_s=st_.host_copy_s,
                 segments=int(segs.shape[0]), mode=pipe._mode, buckets=buckets(pipe))
    # every rank's delays, in the device band layout, for rank 0
    run_taus = pipe._assemble(torch.as_tensor(np.stack(rec.taus)).to(pipe.device), 0,
                              "the delays")
    good = out["mdccm"] > 0.6
    check(int(good.sum()) > 0, "no confident window")
    err = baz_error(out["baz"][good], WORKLOADS[args.workload]["stream"]["baz_deg"])
    vel = float(np.median(out["vel"][good]))
    vel_true = WORKLOADS[args.workload]["stream"]["trace_vel_kms"]
    stats.update(median_baz_err_deg=err, median_vel_kms=vel, confident=int(good.sum()))
    check(err < 5.0, f"median back-azimuth off by {err:.2f} deg")
    check(abs(vel - vel_true) < 0.1 * vel_true, f"median velocity {vel:.4f} km/s")
    if mesh.rank != 0:
        return {}

    t0 = time.perf_counter()
    with DelayRecorder() as rec:
        seq = pipe.run_reference_sequential(segs)
    stats["sequential_s"] = time.perf_counter() - t0
    exact = args.xcorr_method == "fused" and pipe.nb == 1
    worst = 0.0
    for k in PACK_KEYS:
        a, b = out[k], seq[k]
        check(a.shape == b.shape, f"{k}: shape {a.shape} against {b.shape}")
        if exact:
            check(np.array_equal(a, b, equal_nan=True),
                  f"{k}: not bit for bit run_reference_sequential")
            continue
        d = np.nan_to_num(np.abs(a.astype(np.float64) - b))
        worst = max(worst, float(d.max()))
        check(bool((d <= TOL + TOL * np.nan_to_num(np.abs(b))).all()),
              f"{k}: differs from run_reference_sequential beyond {TOL} ({d.max():.3e})")
    stats["max_abs_diff_sequential"] = worst
    stats["bit_for_bit_sequential"] = all(np.array_equal(out[k], seq[k], equal_nan=True)
                                          for k in PACK_KEYS)
    if args.alpha < 1.0:
        stats["lts_same_delay_share"] = check_flags(pipe, out, seq, run_taus,
                                                    np.stack(rec.taus))
    return {**{f"out_{k}": v for k, v in out.items()},
            **{f"seq_{k}": v for k, v in seq.items()},
            "out_tau": run_taus[:, pipe._band_inv_perm]}     # the plan's band order


def check_flags(pipe, out, seq, run_taus, seq_taus) -> float:
    """The LTS flags against the oracle's on every window whose delays are
    bit-identical (at least SAME_MIN of them).  Delays are (S, B, Wmax, P)
    in the device band layout, flags in the plan's band order."""
    perm = pipe._band_perm
    wm = pipe.base.state_dict()["win_mask"].cpu().numpy()[perm]
    same = (run_taus == seq_taus).all(axis=-1) & wm[None]
    bad = (out["flags"][:, perm] != seq["flags"][:, perm]).any(axis=-1) & same
    check(not bad.any(), f"LTS flags differ on {int(bad.sum())} windows with "
                         "bit-identical delays")
    share = float(same.sum()) / max(1, int(wm.sum()) * len(same))
    check(share >= SAME_MIN, f"only {share:.4f} of the windows have bit-identical delays")
    return share


def run_monitor(args, mesh, stats) -> dict:
    """StreamingMonitor across the processes: rank 0 persists, resume, one
    deleted segment redone alone."""
    from narrow_band_least_squares_tpu_torch.models import StreamingMonitor

    st, plan, rij, freqlist = inputs(args.workload, args.alpha, args.hours)
    writer = mesh.rank == 0
    mon = StreamingMonitor(plan, rij, args.monitor_dir, freqlist, alpha=args.alpha,
                           mesh=mesh, xcorr_method=args.xcorr_method,
                           device=args.device)
    n_seg = len(mon.segment_starts(st))
    zero_launches()
    t0 = time.perf_counter()
    recs = mon.process(st)
    synchronize(args.device)
    stats["wall_s"] = time.perf_counter() - t0
    stats["launches"] = launches()
    stats.update(segments=n_seg, batch=mon.batch, buckets=buckets(mon.pipe),
                 halo_bytes=mesh.stats.halo_bytes,
                 gather_bytes=mesh.stats.gather_bytes,
                 broadcast_bytes=mesh.stats.broadcast_bytes,
                 host_copy_bytes=mesh.stats.host_copy_bytes,
                 host_copy_s=mesh.stats.host_copy_s)
    files = sorted(f for f in os.listdir(args.monitor_dir) if f.endswith(".txt"))
    if writer:
        check(len(recs) == n_seg, f"{len(recs)} segments persisted, not {n_seg}")
        check(len(files) == n_seg, f"{len(files)} .txt files, not {n_seg}")
    else:
        check(recs == [], "a rank other than 0 persisted")
    mesh.barrier()
    check(mon.process(st) == [], "resume redid segments")
    mesh.barrier()
    victim = mon.segment_starts(st)[1][1]
    if writer:
        os.remove(os.path.join(args.monitor_dir, mon._seg_name(victim) + ".txt"))
    mesh.barrier()
    recs3 = mon.process(st)
    if writer:
        check(len(recs3) == 1 and abs(recs3[0].start_epoch - victim) < 1e-6,
              f"resume after a deletion redid {[r.start_epoch for r in recs3]}")
    mon.close()
    mesh.barrier()
    vel, baz, mdccm, t, num = mon.read_all()
    good = mdccm > 0.6
    err = baz_error(baz[good], WORKLOADS[args.workload]["stream"]["baz_deg"])
    stats.update(median_baz_err_deg=err, confident=int(good.sum()))
    check(err < 5.0, f"monitor median back-azimuth off by {err:.2f} deg")
    return {"mon_vel": vel, "mon_baz": baz, "mon_mdccm": mdccm, "mon_t": t,
            "mon_num": np.asarray(num)}


def run_multiarray(args, mesh, stats) -> dict:
    """MultiArrayPipeline on the mesh against each array alone on this rank's
    device: bit for bit with 'fused' on the card, within 1e-5 otherwise."""
    import torch
    from narrow_band_least_squares_tpu_torch.models import (
        MultiArrayPipeline, NarrowBandPipeline,
    )

    plan, rijs, data, truth = multiarray_inputs(args.workload)
    kw = dict(xcorr_method=args.xcorr_method, device=args.device, alpha=args.alpha)
    pipe = MultiArrayPipeline(plan, rijs, mesh=mesh, **kw)
    pipe.run_raw(data)
    mesh.barrier()
    mesh.reset_stats()
    zero_launches()
    t0 = time.perf_counter()
    out = pipe.run_raw(data)
    synchronize(args.device)
    stats["wall_s"] = time.perf_counter() - t0
    stats["launches"] = launches()
    stats.update(arrays=len(rijs), local_arrays=len(pipe._arrays),
                 buckets=len(pipe.base._buckets), gather_bytes=mesh.stats.gather_bytes,
                 host_copy_bytes=mesh.stats.host_copy_bytes,
                 host_copy_s=mesh.stats.host_copy_s)
    exact = args.xcorr_method == "fused" and torch.device(args.device).type == "cuda"
    worst = 0.0
    res = {}
    for k, rij in enumerate(rijs):
        one = NarrowBandPipeline(plan, rij, **kw).run_raw(data[k])
        for name, v in one.items():
            a, b = out[name][k], v
            if exact:
                check(torch.equal(a.nan_to_num(), b.nan_to_num()),
                      f"array {k} {name}: not bit for bit the single-array run")
                continue
            d = (a.double() - b.double()).abs().nan_to_num()
            worst = max(worst, float(d.max()))
            check(bool((d <= TOL + TOL * b.double().abs().nan_to_num()).all()),
                  f"array {k} {name}: differs from the single-array run by {d.max():.3e}")
        good = out["mdccm"][k].cpu().numpy() > 0.6
        err = baz_error(out["baz"][k].cpu().numpy()[good], truth[k])
        check(err < 6.0, f"array {k}: median back-azimuth off by {err:.2f} deg")
    stats["max_abs_diff_single"] = worst
    for name, v in out.items():
        res[f"multi_{name}"] = v.cpu().numpy()
    return res


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def launch(nproc: int, argv, timeout_s: float = 300.0, threads: int = 0):
    """Start ``nproc`` ranks of this worker on a free localhost port and
    wait for all of them (``timeout_s`` in all; on expiry every rank is
    killed).  ``threads`` caps each rank's CPU threads (0: no cap).  Each
    rank writes to its own temporary file, so none can block on a full
    pipe while another is waited for.  Raises unless every rank exits 0
    with ``NBLS_SMOKE_OK``.  Returns (per-rank stats, per-rank output)."""
    import subprocess
    import tempfile

    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    base = dict(os.environ)
    base.update(MASTER_ADDR="localhost", MASTER_PORT=str(free_port()),
                WORLD_SIZE=str(nproc),
                PYTHONPATH=root + os.pathsep + base.get("PYTHONPATH", ""))
    if threads:
        base.update(OMP_NUM_THREADS=str(threads), MKL_NUM_THREADS=str(threads))

    def read(f) -> str:
        f.seek(0)
        return f.read()

    procs, logs = [], []
    try:
        for r in range(nproc):
            logs.append(tempfile.TemporaryFile("w+"))
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "narrow_band_least_squares_tpu_torch.parallel.smoke",
                 *argv], env=dict(base, RANK=str(r), LOCAL_RANK=str(r)), cwd=root,
                stdout=logs[-1], stderr=subprocess.STDOUT, text=True))
        deadline = time.monotonic() + timeout_s
        try:
            for p in procs:
                p.wait(timeout=max(1.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            for p in procs:
                p.kill()
                p.wait()
            raise RuntimeError(f"the {nproc} ranks did not end within {timeout_s} s:\n"
                               + "\n".join(f"--- rank {r}\n{read(f)[-3000:]}"
                                           for r, f in enumerate(logs)))
        outs = [read(f) for f in logs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    stats = []
    for r, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0 or "NBLS_SMOKE_OK" not in out:
            raise RuntimeError(f"rank {r} of {nproc} failed (rc={p.returncode}):\n"
                               f"{out[-6000:]}")
        line = [ln for ln in out.splitlines() if ln.startswith("NBLS_SMOKE_RANK ")][-1]
        stats.append(json.loads(line[len("NBLS_SMOKE_RANK "):]))
    return stats, outs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mesh-time", type=int, default=0,
                    help="time shards (0: the world size over the band shards)")
    ap.add_argument("--mesh-band", type=int, default=1, help="band shards")
    ap.add_argument("--alpha", type=float, default=1.0, help="1.0 OLS; below 1 LTS")
    ap.add_argument("--xcorr-method", default="mxu",
                    choices=("mxu", "pallas", "fused", "fft"))
    ap.add_argument("--workload", default="small", choices=sorted(WORKLOADS))
    ap.add_argument("--hours", type=float, default=0.0,
                    help="cut the workload's stream to this many hours")
    ap.add_argument("--monitor-dir", default="",
                    help="run StreamingMonitor into this directory instead")
    ap.add_argument("--multiarray", action="store_true",
                    help="run MultiArrayPipeline on the mesh instead")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--backend", default=None,
                    help="nccl or gloo (default: NCCL on CUDA, gloo on the CPU)")
    ap.add_argument("--out", default="", help="npz of the results, written by rank 0")
    args = ap.parse_args(argv)

    import torch
    import torch.distributed as dist

    from narrow_band_least_squares_tpu_torch.parallel import (
        initialize_distributed, make_mesh,
    )

    initialize_distributed(args.backend, device=args.device)
    ws = dist.get_world_size() if dist.is_initialized() else 1
    nb = args.mesh_band
    nt = args.mesh_time or ws // nb
    mesh = make_mesh(nt, nb)
    if torch.device(args.device).type == "cuda":
        torch.set_float32_matmul_precision("highest")
    stats = {"rank": mesh.rank, "t": mesh.t, "b": mesh.b, "mesh": [nt, nb],
             "backend": mesh.backend, "device": str(args.device),
             "xcorr_method": args.xcorr_method, "alpha": args.alpha,
             "workload": args.workload}
    try:
        if args.monitor_dir:
            res = run_monitor(args, mesh, stats)
        elif args.multiarray:
            res = run_multiarray(args, mesh, stats)
        else:
            res = run_pipeline(args, mesh, stats)
    except Failure as e:
        print(f"NBLS_SMOKE_FAIL rank={mesh.rank}: {e}", flush=True)
        print("NBLS_SMOKE_RANK " + json.dumps(stats), flush=True)
        return 1
    print("NBLS_SMOKE_RANK " + json.dumps(stats), flush=True)
    if args.out and mesh.rank == 0:
        np.savez(args.out, **res)
    mesh.barrier()
    if dist.is_initialized():
        dist.destroy_process_group()
    print(f"NBLS_SMOKE_OK rank={mesh.rank} mesh=({nt}x{nb}) alpha={args.alpha} "
          f"method={args.xcorr_method}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
