"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``narrow_band_least_squares_tpu_torch/
csrc`` into ``build/nbls_torch_kernels/``, holds each kernel against its
plain PyTorch version on the card, drives the canonical OLS narrow-band run
(8 elements, 20 Hz, 1200 s, 8 log bands over 0.1-5 Hz, adaptive 50/60/30 s
windows, cheby1 order 2) end to end through
``api.narrow_band_least_squares(..., device="cuda")``, checks it against
the same run on the CPU and against the synthetic wave's true back-azimuth
and velocity, and times the step (canonical and 50-band plans) and each
kernel.  Every failure exits non-zero.  The second-to-last line is the
kernels' JSON record; the last is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.

``--phases`` picks a subset (``build,kernel,main,timing``) for a quick check.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

# canonical workload (bench.py / examples/example.py)
FS, DURATION_S, NCHANS = 20.0, 1200.0, 8
BAZ_TRUE, VEL_TRUE = 230.0, 0.34
FMIN, FMAX, NBANDS = 0.1, 5.0, 8
WINLEN, WINLEN_1, WINLEN_X, WINOVER = 50, 60, 30, 0.5
SEED = 42
MDCCM_THRESH = 0.6
TOL = 1e-4            # pipeline outputs, rtol and atol
KERNEL_RTOL = 1e-5    # icorr_peak peak against the plain version

# H100 SXM published peaks (NVIDIA data sheet, dense, 700 W)
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def gpu_label() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def canonical_inputs():
    from narrow_band_least_squares_tpu_torch.io import synthetic_plane_wave
    from narrow_band_least_squares_tpu_torch.utils import get_freqlist, get_winlenlist

    st = synthetic_plane_wave(
        nchans=NCHANS, duration_s=DURATION_S, fs=FS, baz_deg=BAZ_TRUE,
        trace_vel_kms=VEL_TRUE, f0=0.8, bandwidth=1.2, snr=8.0, seed=SEED,
    )
    freqlist, nbands, _ = get_freqlist(FMIN, FMAX, "log", NBANDS)
    winlens = get_winlenlist("adaptive", nbands, WINLEN, WINLEN_1, WINLEN_X)
    return st, freqlist, winlens


def cuda_time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of ``fn()`` over ``reps`` calls, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


# --------------------------------------------------------------------------
# icorr_peak against its plain version
# --------------------------------------------------------------------------

def check_icorr(name, cs2, e2, lo, hi):
    """Kernel vs plain version on the card.  ``idx`` must be exact except at
    near-ties split by accumulation order, where the kernel's own value at
    its ``idx`` must lie within KERNEL_RTOL * max|peak| of the reference peak.
    Returns (max |peak error|, near-tie rows)."""
    import torch
    from narrow_band_least_squares_tpu_torch.ops.kernels import xcorr_peak as XP

    pk, ix = XP.icorr_peak(cs2, e2, lo, hi)
    pr, ir = XP.icorr_peak_reference(cs2, e2, lo, hi)
    torch.cuda.synchronize()
    fin = torch.isfinite(pr)
    scale = float(pr[fin].abs().max()) if bool(fin.any()) else 1.0
    if not torch.equal(torch.isfinite(pk), fin):
        fail(f"icorr_peak {name}: finite pattern of peak differs")
    err = (pk[fin] - pr[fin]).abs()
    max_err = float(err.max()) if err.numel() else 0.0
    if bool((err > KERNEL_RTOL * pr[fin].abs() + KERNEL_RTOL * scale).any()):
        fail(f"icorr_peak {name}: peak differs beyond rtol {KERNEL_RTOL} "
             f"(max abs err {max_err:.3e}, scale {scale:.3e})")
    bad = (ix != ir).nonzero().flatten()
    if bad.numel():
        # the kernel's correlation at its own idx, in float64
        rows = bad
        own = (cs2[rows].double() * e2[:, ix[rows].long()].double().T).sum(-1)
        gap = (own - pr[rows].double()).abs()
        if bool((gap > KERNEL_RTOL * scale).any()):
            fail(f"icorr_peak {name}: {bad.numel()} rows pick another lag "
                 f"that is not a near-tie (max gap {float(gap.max()):.3e})")
    log(f"icorr_peak {name}: R={cs2.shape[0]} K2p={cs2.shape[1]} "
        f"nlag={e2.shape[1]}: max|peak err| {max_err:.3e} "
        f"(scale {scale:.3e}), idx exact except {bad.numel()} near-tie rows")
    return max_err, int(bad.numel())


def random_case(R, K2p, nlag, seed):
    """Gaussian cs2/e2; row r searches a centred range of random width."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    cs2 = torch.randn(R, K2p, generator=g, device="cuda")
    e2 = torch.randn(K2p, nlag, generator=g, device="cuda")
    half = nlag // 2
    bh = torch.randint(0, half + 1, (R,), generator=g, device="cuda")
    return cs2, e2, (half - bh).to(torch.int32), (half + bh).to(torch.int32)


TIE_LAGS = (5, 130, 259)   # in three different 64-lag tiles of 260 lags


def tie_case(R=300, K2p=256, nlag=260, seed=4):
    """Non-negative cs2 and three identical, dominant e2 columns: every row's
    maximum is an exact tie among the TIE_LAGS it searches, so the first of
    them at or after its ``lo`` must win."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    cs2 = torch.rand(R, K2p, generator=g, device="cuda")
    e2 = torch.randn(K2p, nlag, generator=g, device="cuda")
    col = 10.0 + torch.rand(K2p, generator=g, device="cuda")
    for l in TIE_LAGS:
        e2[:, l] = col
    lo = torch.randint(0, TIE_LAGS[-1] + 1, (R,), generator=g,
                       device="cuda").to(torch.int32)
    hi = torch.full((R,), nlag - 1, dtype=torch.int32, device="cuda")
    want = torch.full((R,), TIE_LAGS[-1], dtype=torch.int32, device="cuda")
    for l in reversed(TIE_LAGS):
        want = torch.where(lo <= l, torch.full_like(want, l), want)
    return cs2, e2, lo, hi, want


def phase_kernel():
    from narrow_band_least_squares_tpu_torch.ops.kernels import xcorr_peak as XP

    check_icorr("canonical-largest-K", *random_case(1092, 2432, 2399, 1))
    check_icorr("canonical-largest-R", *random_case(2212, 1280, 1199, 2))
    check_icorr("ragged-small", *random_case(77, 200, 131, 3))
    cs2, e2, lo, hi, want = tie_case()
    check_icorr("tie", cs2, e2, lo, hi)
    _, ix = XP.icorr_peak(cs2, e2, lo, hi)
    wrong = int((ix != want).sum())
    if wrong:
        fail(f"icorr_peak tie: {wrong} rows did not pick the first maximum")
    log(f"icorr_peak tie: all {cs2.shape[0]} rows picked the first of the "
        f"tied lags {TIE_LAGS}")


# --------------------------------------------------------------------------
# the main path
# --------------------------------------------------------------------------

def run_api(st, freqlist, winlens, device):
    from narrow_band_least_squares_tpu_torch import api

    fr = np.logspace(-2, np.log10(FS / 2), 100)
    return api.narrow_band_least_squares(
        winlens, WINOVER, 1.0, st, st.latitudes, st.longitudes, NBANDS,
        None, None, freqlist, "log", fr, "cheby1", 2, 0.01, device=device,
    )


def compare_outputs(gpu, cpu, ncl):
    """vel/baz/MdCCM/sig_tau within TOL on confident windows (MdCCM > 0.6),
    and at least 99% of all valid windows within TOL."""
    names = ("vel", "baz", "mdccm", None, None, "sig_tau")
    ok_all, n_all = 0, 0
    worst = 0.0
    for b, n in enumerate(ncl):
        conf = cpu[2][b, :n] > MDCCM_THRESH
        close = np.ones(n, dtype=bool)
        for i, nm in enumerate(names):
            if nm is None:
                continue
            g, c = gpu[i][b, :n], cpu[i][b, :n]
            if nm == "baz":  # compare on the circle
                d = np.abs((g - c + 180.0) % 360.0 - 180.0)
            else:
                d = np.abs(g - c)
            lim = TOL + TOL * np.abs(c)
            close &= (d <= lim) | (np.isnan(g) & np.isnan(c))
            if conf.any():
                worst = max(worst, float(np.max((d / lim)[conf])))
        if not close[conf].all():
            fail(f"band {b}: {int((~close[conf]).sum())} confident windows "
                 f"differ between cuda and cpu beyond {TOL}")
        ok_all += int(close.sum())
        n_all += n
    share = ok_all / n_all
    log(f"main path cuda vs cpu: confident windows within {TOL} "
        f"(worst |d|/tol {worst:.3f}); all valid windows within {TOL}: "
        f"{ok_all}/{n_all} = {share:.4f}")
    if share < 0.99:
        fail("fewer than 99% of valid windows agree between cuda and cpu")


def ground_truth(out, ncl):
    vel, baz, mdccm = out[0], out[1], out[2]
    checked = 0
    for b, n in enumerate(ncl):
        conf = mdccm[b, :n] > MDCCM_THRESH
        if conf.sum() < 3:
            continue
        db = (np.median(baz[b, :n][conf]) - BAZ_TRUE + 180.0) % 360.0 - 180.0
        mv = float(np.median(vel[b, :n][conf]))
        log(f"band {b}: {int(conf.sum())} confident windows, median baz "
            f"{BAZ_TRUE + db:.2f} deg, median vel {mv:.4f} km/s")
        if abs(db) > 3.0 or abs(mv - VEL_TRUE) > 0.1 * VEL_TRUE:
            fail(f"band {b}: ground truth missed (baz {BAZ_TRUE}, vel {VEL_TRUE})")
        checked += 1
    if checked == 0:
        fail("no band has confident windows")


def phase_main():
    import torch
    from narrow_band_least_squares_tpu_torch.ops.kernels import xcorr_peak as XP

    st, freqlist, winlens = canonical_inputs()
    XP.launches = 0
    t0 = time.perf_counter()
    gpu = run_api(st, freqlist, winlens, "cuda")
    torch.cuda.synchronize()
    t_first = time.perf_counter() - t0
    launches = XP.launches
    log(f"main path (cuda, first call incl. host set-up): {t_first:.3f} s, "
        f"icorr_peak launches {launches}")
    if launches == 0:
        fail("the main path launched no icorr_peak kernel")
    ncl = gpu[6]
    for i, nm in ((0, "vel"), (1, "baz"), (2, "mdccm"), (5, "sig_tau")):
        valid = np.concatenate([gpu[i][b, :n] for b, n in enumerate(ncl)])
        if gpu[i].shape != (NBANDS, gpu[0].shape[1]):
            fail(f"{nm} has shape {gpu[i].shape}")
        if nm != "vel" and not np.isfinite(valid).all():
            fail(f"{nm} has non-finite values in valid windows")
    cpu = run_api(st, freqlist, winlens, "cpu")
    compare_outputs(gpu, cpu, ncl)
    ground_truth(gpu, ncl)
    return launches


# --------------------------------------------------------------------------
# timings
# --------------------------------------------------------------------------

def capture_icorr_inputs(pipe, data):
    """Run one step with a recorder around the xcorr module's icorr_peak, and
    return the inputs of every launch (these launches are not counted as the
    main path's)."""
    from narrow_band_least_squares_tpu_torch.ops import xcorr as XC

    real, seen = XC.icorr_peak, []

    def rec(cs2, e2, lo, hi):
        seen.append((cs2, e2, lo, hi))
        return real(cs2, e2, lo, hi)

    XC.icorr_peak = rec
    try:
        pipe.run_raw(data)
    finally:
        XC.icorr_peak = real
    return seen


def icorr_work(cs2, e2, lo, hi):
    """(flops, bytes) the function needs on these inputs: each row searches
    hi - lo + 1 lags over K2p terms; each input read once, outputs once."""
    import torch

    span = torch.clamp(hi.long() - lo.long() + 1, min=0).sum().item()
    flops = 2.0 * cs2.shape[1] * span
    nbytes = 4.0 * (cs2.numel() + e2.numel() + lo.numel() + hi.numel()
                    + 2 * cs2.shape[0])
    return flops, nbytes


def library_peak(cs2, e2, lo, hi):
    """The PyTorch yardstick: one matmul, a [lo, hi] mask, torch.max."""
    import torch

    cc = torch.matmul(cs2, e2)
    col = torch.arange(cc.shape[1], device=cc.device)
    bad = (col[None, :] < lo[:, None]) | (col[None, :] > hi[:, None])
    return cc.masked_fill_(bad, float("-inf")).max(dim=1)


def profile_step(label, pipe, data, steps=5):
    """Device time by kernel name over a few steps (torch.profiler), and the
    device's busy share of the wall time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            pipe.run_raw(data)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:   # kernels and copies only
            continue
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(e, "self_cuda_time_total", 0.0)
        if dev_us > 0:
            rows.append((dev_us, e.key, e.count))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows) * 1e-6
    log(f"[{label}] profile, canonical, {steps} steps: wall "
        f"{wall / steps * 1e3:.4f} ms/step, device busy "
        f"{busy / steps * 1e3:.4f} ms/step ({100 * busy / wall:.1f}% busy)")
    for dev_us, key, count in rows[:12]:
        log(f"[{label}]   {dev_us / steps / 1e3:9.4f} ms/step  "
            f"{count // steps:4d} calls/step  {key[:90]}")


def phase_timing(label, launches_main):
    import torch
    from narrow_band_least_squares_tpu_torch.models import NarrowBandPipeline
    from narrow_band_least_squares_tpu_torch.ops.kernels import xcorr_peak as XP
    from narrow_band_least_squares_tpu_torch.utils import (
        get_freqlist, get_rij, get_winlenlist, make_plan,
    )

    st, freqlist, winlens = canonical_inputs()
    rij = get_rij(st.latitudes, st.longitudes, st.nchans)
    plans = {"canonical": make_plan(freqlist, "log", winlens, WINOVER,
                                    st.npts, st.fs)}
    fl50, nb50, _ = get_freqlist(FMIN, FMAX, "log", 50)
    wl50 = get_winlenlist("adaptive", nb50, WINLEN, WINLEN_1, WINLEN_X)
    plans["dense50"] = make_plan(fl50, "log", wl50, WINOVER, st.npts, st.fs)

    rec = None
    for name, plan in plans.items():
        pipe = NarrowBandPipeline(plan, rij, filter_type="cheby1", alpha=1.0,
                                  device="cuda")
        XP.launches = 0
        pipe.run_raw(st.data)
        per_step = XP.launches
        ms = cuda_time_ms(lambda: pipe.run_raw(st.data), reps=20)
        nwin = sum(plan.num_compute_list)
        log(f"[{label}] {name}: {ms:.4f} ms per run_raw step, "
            f"{nwin / ms * 1e3:.1f} windows solved/s, icorr_peak launches "
            f"per step {per_step}")
        if name != "canonical":
            continue
        profile_step(label, pipe, st.data)
        seen = capture_icorr_inputs(pipe, st.data)
        k_ms = p_ms = l_ms = flops = nbytes = 0.0
        max_err = 0.0
        for i, args in enumerate(seen):
            err, _ = check_icorr(f"main-path bucket {i}", *args)
            max_err = max(max_err, err)
            kt = cuda_time_ms(lambda: XP.icorr_peak(*args), reps=20)
            pt = cuda_time_ms(lambda: XP.icorr_peak_reference(*args), reps=10)
            lt = cuda_time_ms(lambda: library_peak(*args), reps=10)
            f, b = icorr_work(*args)
            bound = max(f / PEAK_FP32_FLOPS, b / PEAK_HBM_BYTES) * 1e3
            log(f"[{label}] icorr_peak bucket {i}: R={args[0].shape[0]} "
                f"K2p={args[0].shape[1]} nlag={args[1].shape[1]}: kernel "
                f"{kt * 1e3:.1f} us, plain {pt * 1e3:.1f} us, library "
                f"{lt * 1e3:.1f} us, bound {bound * 1e3:.1f} us "
                f"({f / 1e9:.3f} GFLOP)")
            k_ms += kt
            p_ms += pt
            l_ms += lt
            flops += f
            nbytes += b
        bound_ms = max(flops / PEAK_FP32_FLOPS, nbytes / PEAK_HBM_BYTES) * 1e3
        bound_by = ("operations" if flops / PEAK_FP32_FLOPS
                    >= nbytes / PEAK_HBM_BYTES else "bytes")
        log(f"[{label}] icorr_peak per canonical step ({len(seen)} launches): "
            f"kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, library "
            f"{l_ms:.4f} ms, bound {bound_ms:.4f} ms by {bound_by} "
            f"({flops / 1e9:.2f} GFLOP); kernel at "
            f"{flops / (k_ms * 1e-3) / 1e12:.2f} TFLOP/s")
        rec = {
            "name": "icorr_peak", "route": "cuda",
            "source": "narrow_band_least_squares_tpu_torch/csrc/xcorr_peak.cu",
            "replaces": "narrow_band_least_squares_tpu/ops/kernels/xcorr_peak.py:94",
            "launches": launches_main, "max_abs_err": max_err,
            "ms": k_ms, "plain_ms": p_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": l_ms,
        }
    return rec


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default="build,kernel,main,timing")
    phases = set(ap.parse_args().phases.split(","))

    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a GPU")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        from narrow_band_least_squares_tpu_torch.ops.kernels import _build
    except ImportError as e:
        fail(f"the port's package is not next to this script: {e}")

    label = gpu_label()
    kind = torch.cuda.get_device_name(0)
    log(f"gpu: {label}; torch.cuda.get_device_name: {kind}; torch "
        f"{torch.__version__}, cuda {torch.version.cuda}")
    torch.set_float32_matmul_precision("highest")

    t0 = time.perf_counter()
    report = _build.build_all()
    log(f"kernel build: {time.perf_counter() - t0:.2f} s for {sorted(report)}")
    for name, r in report.items():
        for line in r["ptxas"].splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    if "kernel" in phases:
        phase_kernel()
    launches = phase_main() if "main" in phases else 0
    if "timing" in phases:
        rec = phase_timing(label, launches)
        log(f"[{label}]")
        log(json.dumps({"kernels": [rec]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
