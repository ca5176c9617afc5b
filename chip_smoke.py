"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``narrow_band_least_squares_tpu_torch/
csrc`` into ``build/nbls_torch_kernels/`` (and its C++ host runtime into
``build/nbls_torch_native/``), holds each kernel against its
plain PyTorch version on the card, drives the canonical OLS narrow-band run
(8 elements, 20 Hz, 1200 s, 8 log bands over 0.1-5 Hz, adaptive 50/60/30 s
windows, cheby1 order 2) end to end through
``api.narrow_band_least_squares(..., device="cuda")``, checks it against
the same run on the CPU and against the synthetic wave's true back-azimuth
and velocity, and times the step (canonical and 50-band plans) and each
kernel.  Every failure exits non-zero.  The second-to-last line is the
kernels' JSON record; the last is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.

Phases, in order (``--phases`` picks a subset for a quick check):

- ``build``: ``nvcc`` on every ``csrc/*.cu``, all at once, and a look at
  the SASS of the tensor-core libraries (``xcorr_peak_tc``,
  ``fused_xcorr``) for tf32 ``HGMMA``, and of the fp32 ('highest')
  kernels for ``FFMA`` and no tensor-core instruction; each kernel's
  ptxas registers and spills, and the fp32 ring tile's shared memory and
  cluster shapes with the clusters the card holds at once (always runs);
- ``kernel``: ``icorr_peak`` against its plain version at each
  ``matmul_precision``: 'highest' (fp32 CUDA cores), 'high' (3xTF32) and
  'default' (1xTF32) on the tensor cores;
- ``main``: the canonical run with the default ``xcorr_method='mxu'`` at
  the default 'high' (tensor-core route), then at 'highest' (fp32 route)
  and 'default';
- ``fused-kernel``: ``fused_xcorr_bucket`` at each precision against its
  plain version of the same precision on every canonical bucket, a
  mixed-length bucket and a ragged random one, at 'highest' also every
  dense50 bucket; chunked launches against one launch bit for bit (at
  'highest' on every bucket);
- ``fused-main``: the canonical run through the API with
  ``set_performance_defaults(xcorr_method='fused')`` at 'high', 'highest'
  and 'default', each on its own route;
- ``multiarray``: ``MultiArrayPipeline`` on four canonical arrays, 'fused'
  at every precision (bit for bit) and 'mxu', against single-array runs,
  and ``BroadbandPipeline``;
- ``sharded``: the (time, band) mesh on ``torch.distributed`` at full
  width (the monitor's 6 h stream on the canonical plan; dense50 for band
  shards): one process over NCCL at world size 1 (a 1x1 mesh) against the
  one-device pipeline, bit for bit with 'fused' and 'mxu'; then ranks of
  the worker ``narrow_band_least_squares_tpu_torch.parallel.smoke``, all
  on ``cuda:0`` over gloo (NCCL cannot put two ranks on one GPU): (time=4)
  'fused' bit for bit its sequential oracle, (2, 2) dense50 'mxu' within
  1e-5 of it, (2, 2) LTS flags on bit-identical delays, each against the
  CPU and the truth; the monitor on 4 ranks (rank 0 writes, resume)
  against the one-process monitor; ``MultiArrayPipeline`` on (time=2)
  against single arrays.  Launches per rank per route, wall times, halo
  bytes and host-copy times;
- ``lts``: the LTS sweep's kernels (``csrc/lts_sweep.cu``: elemental
  solves, residuals, refit, ``sweep``, the C-steps and trimmed objective
  of a candidate block in one launch, and ``final``, the final subset of
  a solve in one launch, one warp a window) bit for bit against their
  plain versions on the canonical sweep's shapes, in bfloat16 and at P =
  120, ``sweep`` also on the funnel's two launches, the capped cell (Q =
  5), the one-band delay roles, P = 120 in chunks of 4096 and every size
  of its thread route (P = 3 to 36, ties, NaN, +inf, -0.0, delay roles),
  ``final`` on the canonical exhaustive, 'auto' and chunked solves,
  adversarial objectives, bfloat16, P = 3 to 64 under every delay-role
  mask, a degenerate co-array, the one-band and capped cells; and timed:
  ``sweep``'s warp route (the design before the thread route) and its
  thread route in turns at the canonical and dense50 shapes, with 0, 1
  and 4 C-steps, ``final`` beside its bound and the separate passes it
  replaced, beside each instance's ptxas registers and spills;
  exact-enumeration LTS (``ALPHA = 0.75``) on the canonical data
  with one incoherent element, through the API on the card and on the CPU,
  exhaustive and with ``PRODUCTION_DEFAULTS``: flags equal on every window
  whose delays are bit-identical (at least 99% of them), ground truth, the
  outlier most flagged, one ``sweep`` (two with the funnel, each on its
  thread route), one ``elemental`` and one ``final`` launched and nothing
  ranked eagerly; the capped-candidate stream (``max_lts_candidates=5``)
  card against CPU, ``lts_solve`` bit for bit; one-band ``ltsva`` (its JAX
  program fuses the delays into the sweep) card against CPU;
  ``residuals2_lag`` held bit for bit to its plain version at P = 15, 28
  and 120 and timed; the sweep's rank against its pairwise definition;
  four merged arrays ('fused') against single-array runs bit for bit; a
  16-element array (7,140 candidates, chunked) against a smaller chunk bit
  for bit, one ``sweep`` a chunk and its final subset on the separate
  passes (``residuals2``, one eager rank, ``refit``), and one-band
  ``ltsva`` on it (``residuals2_lag``); the LTS step with the sweep's
  arithmetic as eager operations, on the separate kernels, through
  ``sweep`` with the final subset's passes and through ``final``, in
  turns; the LTS step, the solve and peak memory on the canonical and
  dense50 plans beside the OLS step, through ``sweep`` with the passes
  and through ``final``, in turns;
- ``monitor``: ``examples/example_monitoring.py``'s workload (6 h in 1200 s
  segments, batches of 4) through ``StreamingMonitor(..., device="cuda")``
  with 'mxu' and 'fused' at 'high': the persisted segments against the
  CPU and against ``pipe.run``, the truth, resume, launches per route, no
  retry; a bfloat16 wire; an LTS monitor on 2 h against the CPU's flags;
  segments and windows per second and the device time per batch;
- ``ingest``: the monitor's stream as a station delivers it: Steim1
  miniSEED written and decoded by the port's C++ codec, fed in arrival
  order (per-channel lag of 0-2 records) through ``StreamingIngest``'s
  native ring into ``StreamingMonitor(..., device="cuda")`` with 'mxu' and
  'fused' at 'high': segments bit for bit the decoded stream's, results
  against ``process()`` of the decoded stream, the CPU and the truth,
  launches per route, every ``.txt`` by the C++ codec; decode, feed and
  persistence times (C++ against Python TSV codec);
- ``golden``: ``tests/data``'s recorded event through the port's
  ``gather_waveforms_fdsn`` (miniSEED decode, StationXML deconvolution) and
  ``api.narrow_band_least_squares(..., device="cuda")`` at ALPHA 1.0 and
  0.75, against ``tests/data/golden.json`` and the CPU;
- ``cli``: the port's command line (``narrow_band_least_squares_tpu_torch.
  __main__.main``, as ``python -m narrow_band_least_squares_tpu_torch``
  runs it) on the card: ``run --synthetic`` with the default config against
  the same command on the CPU, the truth, ``config_used.json`` and the
  figures; ``monitor`` on the monitor's 6 h stream as Steim1 miniSEED with
  'mxu' and 'fused', bit for bit ``StreamingMonitor.process()`` of the
  decoded stream, and resume; ``fetch`` of the golden fixture (served
  offline), then ``run`` on it against ``tests/data/golden.json``; launches
  per route and the command's phase times (``utils.profiling.PhaseTimers``);
- ``options``: the options ported last.  ``icorr_peak``'s neighbour route
  (sub-sample delays) at each precision: (peak, idx) bit for bit the
  integer route, the neighbours against the route's own products and the
  plain version, on random, tie and tile-edge cases (peaks on a tile's
  first and last column, next to a tile no row searches, at lag 0 and
  nlag - 1); the canonical run with ``subsample_delays=True`` at 'high',
  'highest' and 'default' (one neighbour launch per bucket, card against
  CPU on windows with equal integer lags, the truth); ``window_method=
  'patches'`` bit for bit 'gather'; float64 bit for bit float32; a
  bfloat16 ``ltsva`` against the CPU's; ``sosfilt`` (the port's own
  kernel, ``filter_stream_scan``, with the JAX package's scan
  contractions) bit for bit its plain version with 2 and 4 sections, and
  against scipy;
  the canonical OLS and LTS runs against the port's NumPy oracle; the
  neighbour route's times beside the integer route's, and peak memory;
- ``timing``: step, per-bucket kernel (per precision) and multi-array
  times, profiles (device time through ``utils.profiling``; the fused
  'highest' step also at dense50), and the fused 'highest' route per step
  with 1, 2 and 4 K parts of its inverse DFT;
- ``graph``: ``NarrowBandPipeline.run`` replays its step from CUDA graphs
  cut at its spans from its second call (``models/graphs.py``): for each
  of the benchmark's two plans ('mxu' at 'high'), 'fused' at 'high' and
  'highest', 'mxu' at 'highest' and 'default', ``subsample_delays``, LTS
  (flags included) and one-band ``api.ltsva``, five graphed calls on five
  segments bit for bit the eager ``run_raw`` of the same segment, one
  capture, no fallback, the graphs a step; replays advance no launch
  counter; graphed against eager ``run`` in turns on the two plans.

Phases that look inside a step (``LtsRecorder``, ``EagerRanks``,
``capture_fused_inputs``, the launch counters) run eager steps:
``run_raw``, or an API call on a pipeline built by that call
(`first_call`).

The ``build`` phase also compiles the port's native host runtime
(``narrow_band_least_squares_tpu_torch/native``, ``g++``) and fails if it
does not build.
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
KERNEL_RTOL = 1e-5    # kernel peak / rho against the plain version
# 'default' (1xTF32) against its emulated plain version: the same exact
# tf32 products summed in another order; measured on an H100 at most
# 2.1e-6 of the largest peak (5.8e-6 before the kernel folded K blocks in
# fp32 registers), so the kernel tolerance holds for it too
DEFAULT_RTOL = 1e-5
# fused_xcorr_bucket at 'default' (one tf32 pass in both products) against
# its emulated plain version, absolute in rho: the cross-spectra, products
# of long sums, are rounded to tf32, so the two sum orders show through
# that rounding.  The tolerance sits above the kernel's distance to its
# emulation (at most 9.7e-5 on an H100) and below the emulation's own
# distance to fp32 (at least 1.57e-4) on every checked case, both logged by
# the fused-kernel phase, so a kernel that computed fp32 would fail
FUSED_DEFAULT_ATOL = 1.2e-4
PRECISIONS = ("highest", "high", "default")
MULTI_TOL = 1e-5      # 'mxu' multi-array against single-array runs
MULTI_BAZ = (200.0, 210.0, 220.0, 230.0)   # benchmarks/scaling.py arrays
PHASES = ("build", "kernel", "main", "fused-kernel", "fused-main",
          "multiarray", "sharded", "lts", "monitor", "ingest", "golden", "cli",
          "options", "timing", "graph")
LTS_ALPHA = 0.75
LTS_OUTLIER = 2       # the canonical element given an incoherent trace (0-based)
LTS_SAME_MIN = 0.99   # share of valid windows whose delays must be bit-identical
CANONICAL_BUCKETS = 8  # window-length buckets of the canonical plan: one lag search each
# the streaming monitor (examples/example_monitoring.py): 6 h in 1200 s segments,
# dispatched 4 at a time; the LTS monitor on 2 h
MONITOR_HOURS, MONITOR_LTS_HOURS = 6.0, 2.0
MONITOR_SEGMENT_S = 1200.0
MONITOR_DISPATCH = 4
# 'mxu' monitor results against pipe.run of all segments in one batch: the
# forward-DFT SGEMM sees another row count (as MULTI_TOL)
MONITOR_RUN_TOL = 1e-5
# ingest: the monitor's stream as Steim1 miniSEED, fed in packets of records
INGEST_PACKET = 64
INGEST_PEAK_COUNTS = 2 ** 15   # the encoding scale puts the peak near this
# golden: tests/test_golden_event.py's plan and tests/test_torch_golden.py's rules
GOLDEN_FMIN, GOLDEN_FMAX, GOLDEN_NBANDS = 0.3, 5.0, 6
GOLDEN_WINLEN_1, GOLDEN_WINLEN_X = 30, 15
GOLDEN_THRESH = 0.5   # golden.json's confident-window MdCCM threshold
GOLDEN_EDGE = 1e-5    # windows this close to it may fall either side
GOLDEN_RTOL = 1e-4    # per-band medians
# cli: the figure files `run` writes with the default config (ALPHA = 1)
CLI_FIGURES = ("Broadband_Least_Squares", "Narrow_Band_Least_Squares",
               "Narrow_Band_Processing_Parameters", "Narrow_Band_Least_Squares_Sigma_Tau")
# graph: graphed calls a configuration, each on a segment of its own, after
# the eager first call; graphed and eager `run` timed in turns this often
GRAPH_SEGMENTS = 5
GRAPH_TURNS = 12

# H100 SXM published peaks (NVIDIA data sheet, dense, 700 W)
PEAK_FP32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_HBM_BYTES = 3.35e12


T_START = time.perf_counter()


def log(msg: str) -> None:
    print(msg, flush=True)


def phase_done(name: str) -> None:
    log(f"== phase {name} done at {time.perf_counter() - T_START:.1f} s")


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


def canonical_inputs(outlier_channels=()):
    from narrow_band_least_squares_tpu_torch.io import synthetic_plane_wave
    from narrow_band_least_squares_tpu_torch.utils import get_freqlist, get_winlenlist

    st = synthetic_plane_wave(
        nchans=NCHANS, duration_s=DURATION_S, fs=FS, baz_deg=BAZ_TRUE,
        trace_vel_kms=VEL_TRUE, f0=0.8, bandwidth=1.2, snr=8.0, seed=SEED,
        outlier_channels=outlier_channels,
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


def device_ms(fn, reps: int) -> float:
    """Mean device time of ``fn()`` over ``reps`` calls queued behind a spin
    kernel, so that they run back to back: the host's launch gaps between
    calls, which ``cuda_time_ms`` counts for short kernels, do not."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)   # ~25 ms: the host queues the calls meanwhile
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


# --------------------------------------------------------------------------
# icorr_peak against its plain version
# --------------------------------------------------------------------------

def own_value(cs2, e2, rows, cols, precision):
    """float64 value of the products the kernel takes at ``precision`` for
    (row, lag) pairs: the exact product ('highest'), or the exact sum of
    the tf32 split products ('high': lo.hi + hi.lo + hi.hi; 'default':
    hi.hi)."""
    from narrow_band_least_squares_tpu_torch.ops.kernels import xcorr_peak as XP

    a, b = cs2[rows], e2[:, cols].T.contiguous()
    if precision == "highest":
        return (a.double() * b.double()).sum(-1)
    (ah, al), (bh, bl) = XP.tf32_split(a), XP.tf32_split(b)
    v = (ah.double() * bh.double()).sum(-1)
    if precision == "high":
        v = v + (al.double() * bh.double() + ah.double() * bl.double()).sum(-1)
    return v


def check_icorr(name, cs2, e2, lo, hi, precision="highest", against=None,
                prepared=None, exact_idx=False):
    """Kernel at ``precision`` vs the plain version at ``against`` (default
    the same precision: the split emulated in fp32 matmuls) on the card.
    ``idx`` must be exact (``exact_idx``), or exact except at near-ties,
    where the kernel's own value at its ``idx`` must lie within rtol *
    max|peak| of the reference peak (rtol: KERNEL_RTOL, or DEFAULT_RTOL for
    'default' against itself).  ``prepared``: the route's operand of e2,
    built here unless given.  Checks that the precision's route launched.  Returns (max |peak
    error|, near-tie rows)."""
    import torch
    from narrow_band_least_squares_tpu_torch.ops.kernels import xcorr_peak as XP

    against = against or precision
    rtol = DEFAULT_RTOL if against == "default" else KERNEL_RTOL
    before = (XP.launches, XP.launches_tc)
    if prepared is None:
        prepared = XP.prepare(e2, precision)
    pk, ix = XP.icorr_peak(cs2, e2, lo, hi, precision=precision, prepared=prepared)
    tc = precision != "highest"
    if (XP.launches - before[0], XP.launches_tc - before[1]) != (int(not tc), int(tc)):
        fail(f"icorr_peak {name} ({precision}) took the wrong route")
    pr, ir = XP.icorr_peak_reference(cs2, e2, lo, hi, precision=against)
    torch.cuda.synchronize()
    fin = torch.isfinite(pr)
    scale = float(pr[fin].abs().max()) if bool(fin.any()) else 1.0
    tag = f"icorr_peak {name} [{precision} vs plain {against}]"
    if not torch.equal(torch.isfinite(pk), fin):
        fail(f"{tag}: finite pattern of peak differs")
    err = (pk[fin] - pr[fin]).abs()
    max_err = float(err.max()) if err.numel() else 0.0
    if bool((err > rtol * pr[fin].abs() + rtol * scale).any()):
        fail(f"{tag}: peak differs beyond rtol {rtol} "
             f"(max abs err {max_err:.3e}, scale {scale:.3e})")
    bad = (ix != ir).nonzero().flatten()
    if bad.numel() and exact_idx:
        fail(f"{tag}: idx differs on {bad.numel()} rows")
    if bad.numel():
        own = own_value(cs2, e2, bad, ix[bad].long(), precision)
        gap = (own - pr[bad].double()).abs()
        if bool((gap > rtol * scale).any()):
            fail(f"{tag}: {bad.numel()} rows pick another lag that is not a "
                 f"near-tie (max gap {float(gap.max()):.3e})")
    log(f"{tag}: R={cs2.shape[0]} K2p={cs2.shape[1]} nlag={e2.shape[1]}: "
        f"max|peak err| {max_err:.3e} (scale {scale:.3e}, "
        f"{max_err / scale:.2e} of it), idx exact except {bad.numel()} "
        f"near-tie rows")
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


TIE_LAGS = (5, 130, 259)   # in three different 64- and 128-lag tiles of 260


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
    """Each route against the plain version of its own precision ('idx'
    exact on every row of the fp32 route), and 'high' also against fp32;
    the tie case at every precision."""
    from narrow_band_least_squares_tpu_torch.ops.kernels import xcorr_peak as XP

    cases = {"canonical-largest-K": random_case(1092, 2432, 2399, 1),
             "canonical-largest-R": random_case(2212, 1280, 1199, 2),
             "ragged-small": random_case(77, 200, 131, 3)}
    cs2, e2, lo, hi, want = tie_case()
    cases["tie"] = (cs2, e2, lo, hi)
    errs = {}
    for prec in PRECISIONS:
        for name, args in cases.items():
            errs[prec] = max(errs.get(prec, 0.0), check_icorr(
                name, *args, precision=prec, exact_idx=prec == "highest")[0])
            if prec == "high":
                check_icorr(name, *args, precision=prec, against="highest")
        _, ix = XP.icorr_peak(cs2, e2, lo, hi, precision=prec,
                              prepared=XP.prepare(e2, prec))
        wrong = int((ix != want).sum())
        if wrong:
            fail(f"icorr_peak tie ({prec}): {wrong} rows did not pick the first "
                 f"maximum")
        log(f"icorr_peak tie ({prec}): all {cs2.shape[0]} rows picked the first "
            f"of the tied lags {TIE_LAGS}")
    return errs


# --------------------------------------------------------------------------
# the main path
# --------------------------------------------------------------------------

def run_api(st, freqlist, winlens, device, alpha=1.0):
    from narrow_band_least_squares_tpu_torch import api

    fr = np.logspace(-2, np.log10(FS / 2), 100)
    return api.narrow_band_least_squares(
        winlens, WINOVER, alpha, st, st.latitudes, st.longitudes, NBANDS,
        None, None, freqlist, "log", fr, "cheby1", 2, 0.01, device=device,
    )


def first_call():
    """Empties the API's pipeline cache, so that the next API call builds
    its pipeline and runs its step eagerly: from a pipeline's second `run`
    on, the card replays the step from CUDA graphs, where hooks inside the
    step see nothing run."""
    from narrow_band_least_squares_tpu_torch import api

    api.set_performance_defaults()


def compare_outputs(gpu, cpu, ncl, label="main path"):
    """vel/baz/MdCCM/sig_tau within TOL on confident windows (MdCCM > 0.6),
    and at least 99% of all valid windows within TOL (sig_tau where both
    sides have it)."""
    names = ("vel", "baz", "mdccm", None, None, "sig_tau")
    ok_all, n_all = 0, 0
    worst = 0.0
    for b, n in enumerate(ncl):
        conf = cpu[2][b, :n] > MDCCM_THRESH
        close = np.ones(n, dtype=bool)
        for i, nm in enumerate(names):
            if nm is None or i >= len(gpu) or gpu[i] is None:
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
            fail(f"{label} band {b}: {int((~close[conf]).sum())} confident windows "
                 f"differ between cuda and cpu beyond {TOL}")
        ok_all += int(close.sum())
        n_all += n
    share = ok_all / n_all
    log(f"{label} cuda vs cpu: confident windows within {TOL} "
        f"(worst |d|/tol {worst:.3f}); all valid windows within {TOL}: "
        f"{ok_all}/{n_all} = {share:.4f}")
    if share < 0.99:
        fail(f"{label}: fewer than 99% of valid windows agree between cuda and cpu")


def ground_truth(out, ncl, baz_true=BAZ_TRUE, vel_true=VEL_TRUE, label=""):
    vel, baz, mdccm = out[0], out[1], out[2]
    checked = 0
    for b, n in enumerate(ncl):
        conf = mdccm[b, :n] > MDCCM_THRESH
        if conf.sum() < 3:
            continue
        db = (np.median(baz[b, :n][conf]) - baz_true + 180.0) % 360.0 - 180.0
        mv = float(np.median(vel[b, :n][conf]))
        log(f"{label}band {b}: {int(conf.sum())} confident windows, median baz "
            f"{baz_true + db:.2f} deg, median vel {mv:.4f} km/s")
        if abs(db) > 3.0 or abs(mv - vel_true) > 0.1 * vel_true:
            fail(f"{label}band {b}: ground truth missed (baz {baz_true}, "
                 f"vel {vel_true})")
        checked += 1
    if checked == 0:
        fail(f"{label}no band has confident windows")


def run_api_at(st, freqlist, winlens, precision):
    """The canonical API run on the card at ``matmul_precision``; returns
    (outputs, launches of the fp32 route, launches of the tensor-core
    route)."""
    import torch
    from narrow_band_least_squares_tpu_torch import api
    from narrow_band_least_squares_tpu_torch.ops.kernels import xcorr_peak as XP

    prev = api.set_performance_defaults(
        matmul_precision=None if precision == "high" else precision)
    try:
        XP.launches = XP.launches_tc = 0
        t0 = time.perf_counter()
        out = run_api(st, freqlist, winlens, "cuda")
        torch.cuda.synchronize()
        t_first = time.perf_counter() - t0
        f32, tc = XP.launches, XP.launches_tc
    finally:
        api.set_performance_defaults(matmul_precision=None)
        api.set_performance_defaults(**prev)
    log(f"main path at {precision} (cuda, first call incl. host set-up): "
        f"{t_first:.3f} s, icorr_peak launches: fp32 route {f32}, "
        f"tensor-core route {tc}")
    return out, f32, tc


def phase_main():
    """The canonical run at the default 'high' must take the tensor-core
    route only, 'highest' the fp32 route only; both match the CPU run and
    the truth.  'default' (1xTF32 may move near-tied lags) takes the
    tensor-core route and must hit the truth.  Returns the main-path
    launches per precision."""
    st, freqlist, winlens = canonical_inputs()
    cpu = None
    launches = {}
    for prec in ("high", "highest", "default"):
        gpu, f32, tc = run_api_at(st, freqlist, winlens, prec)
        own, other = (f32, tc) if prec == "highest" else (tc, f32)
        if own == 0 or other != 0:
            fail(f"the main path at {prec} must launch only the "
                 f"{'fp32' if prec == 'highest' else 'tensor-core'} route")
        launches[prec] = own
        ncl = gpu[6]
        check_shapes(gpu, ncl, NBANDS)
        if prec != "default":
            if cpu is None:
                cpu = run_api(st, freqlist, winlens, "cpu")
            compare_outputs(gpu, cpu, ncl)
        ground_truth(gpu, ncl, label=f"{prec} ")
    return launches


def check_shapes(out, ncl, nbands):
    """(B, width) outputs, finite baz/MdCCM/sig_tau on every valid window."""
    for i, nm in ((0, "vel"), (1, "baz"), (2, "mdccm"), (5, "sig_tau")):
        valid = np.concatenate([out[i][b, :n] for b, n in enumerate(ncl)])
        if out[i].shape != (nbands, out[0].shape[1]):
            fail(f"{nm} has shape {out[i].shape}")
        if nm != "vel" and not np.isfinite(valid).all():
            fail(f"{nm} has non-finite values in valid windows")


# --------------------------------------------------------------------------
# fused_xcorr_bucket against its plain version
# --------------------------------------------------------------------------

def capture_fused_inputs(pipe, data):
    """Run one step with a recorder around fused_xcorr_bucket and return
    the positional arguments of every launch (not counted as the main
    path's)."""
    from narrow_band_least_squares_tpu_torch.ops.kernels import fused_xcorr as FX

    real, seen = FX.fused_xcorr_bucket, []

    def rec(*args, **kw):
        seen.append(args)
        return real(*args, **kw)

    FX.fused_xcorr_bucket = rec
    try:
        pipe.run_raw(data)
    finally:
        FX.fused_xcorr_bucket = real
    return seen


def check_fused(name, args, precision="highest"):
    """Kernel at ``precision`` vs the plain version of the same precision
    (the tf32 split emulated in fp32 matmuls) on the card.  ``rho`` within
    the precision's tolerance (KERNEL_RTOL as rtol and atol, or
    FUSED_DEFAULT_ATOL at 'default'); ``idx`` exact except at near-ties,
    where the correlation at the kernel's own ``idx`` must lie within the
    atol (in rho units) of the maximum over [lo, hi] (float64 at 'highest',
    the fp32 emulation otherwise).  At 'default' also logs the emulation's
    and the kernel's distance to fp32, which the tolerance must stay below.
    Checks that the precision's route launched.  Returns (max |rho error|,
    near-tie rows)."""
    import torch
    from narrow_band_least_squares_tpu_torch.ops.kernels import fused_xcorr as FX

    rtol, atol = ((0.0, FUSED_DEFAULT_ATOL) if precision == "default" else
                  (KERNEL_RTOL, KERNEL_RTOL))
    prepared = FX.prepare(*args[6:10], precision)
    before = (FX.launches, FX.launches_tc)
    rho, idx = FX.fused_xcorr_bucket(*args, precision=precision, prepared=prepared)
    tc = precision != "highest"
    if (FX.launches - before[0], FX.launches_tc - before[1]) != (int(not tc), int(tc)):
        fail(f"fused_xcorr_bucket {name} ({precision}) took the wrong route")
    rr, ir = FX.fused_xcorr_bucket_reference(*args, precision=precision)
    torch.cuda.synchronize()
    tag = f"fused_xcorr_bucket {name} [{precision}]"
    if not torch.isfinite(rho).all():
        fail(f"{tag}: non-finite rho")
    err = (rho - rr).abs()
    max_err = float(err.max())
    if bool((err > rtol * rr.abs() + atol).any()):
        fail(f"{tag}: rho differs beyond rtol {rtol} atol {atol} (max abs err "
             f"{max_err:.3e})")
    bad = idx != ir
    nbad = int(bad.sum())
    if nbad:
        y, hop, maxstart, lo, hi, lm, Cf, Sf, Ec, Es, pairs, W = args
        dt = torch.float64 if precision == "highest" else torch.float32
        cc, denom = FX.fused_correlation(
            y.to(dt), hop, maxstart, lm.to(dt), Cf.to(dt), Sf.to(dt),
            Ec.to(dt), Es.to(dt), pairs, W, precision)
        col = torch.arange(cc.shape[-1], device=cc.device)
        valid = (col >= lo[:, :, None, None]) & (col <= hi[:, :, None, None])
        best = cc.masked_fill(~valid, float("-inf")).amax(-1)
        own = cc.gather(-1, idx.long()[..., None])[..., 0]
        gap = ((best - own) / denom)[bad]
        if bool((gap > atol).any()):
            fail(f"{tag}: {nbad} rows pick another lag that is not a near-tie "
                 f"(max gap {float(gap.max()):.3e})")
    extra = ""
    if precision == "default":
        r32, _ = FX.fused_xcorr_bucket_reference(*args, precision="highest")
        extra = (f"; the plain 'default' lies {float((rr - r32).abs().max()):.3e} "
                 f"and the kernel {float((rho - r32).abs().max()):.3e} from the "
                 f"plain fp32")
    log(f"{tag}: y {tuple(args[0].shape)} Lg={args[5].shape[1]} "
        f"Kp={args[6].shape[1]} nlag={args[8].shape[1]} W={args[11]} "
        f"P={args[10].shape[0]}: max|rho err| {max_err:.3e} (rtol {rtol}, atol "
        f"{atol}), "
        f"idx exact except {nbad} near-tie rows{extra}")
    return max_err, nbad


def check_fused_chunks(name, args, precision, windows=8):
    """The launch run in chunks of ``windows`` windows (a smaller
    ``SCRATCH_FLOATS``; chunks that cut across band rows, the last one
    short) gives the one-chunk launch's rho and idx bit for bit."""
    import torch
    from narrow_band_least_squares_tpu_torch.ops.kernels import fused_xcorr as FX

    y, lm, Ec, pairs, W = args[0], args[5], args[8], args[10], args[11]
    Bg, C, T = y.shape
    shape = (Bg, C, T, lm.shape[1], W, Ec.shape[0], Ec.shape[1], pairs.shape[0],
             precision)
    whole, _ = FX.plan_chunks(*shape)
    at = FX.scratch_shapes(C, lm.shape[1], Ec.shape[0], Ec.shape[1], pairs.shape[0],
                           precision, windows)
    prepared = FX.prepare(*args[6:10], precision)
    ref = FX.fused_xcorr_bucket(*args, precision=precision, prepared=prepared)
    saved = FX.SCRATCH_FLOATS
    FX.SCRATCH_FLOATS = max(int(np.prod(v)) for v in at.values())
    try:
        chunk, _ = FX.plan_chunks(*shape)
        got = FX.fused_xcorr_bucket(*args, precision=precision, prepared=prepared)
    finally:
        FX.SCRATCH_FLOATS = saved
    torch.cuda.synchronize()
    nchunks = -(-Bg * W // chunk)
    if whole != Bg * W or chunk != windows or nchunks < 2:
        fail(f"fused_xcorr_bucket {name} [{precision}]: chunk plan {whole} / "
             f"{chunk} windows does not test chunking")
    if not all(torch.equal(a, b) for a, b in zip(ref, got)):
        fail(f"fused_xcorr_bucket {name} [{precision}]: {nchunks} chunks of "
             f"{chunk} windows differ from one launch")
    log(f"fused_xcorr_bucket {name} [{precision}]: {nchunks} chunks of {chunk} "
        f"windows equal one chunk of {whole} bit for bit")


def fused_random_case(seed=6):
    """Three bands of 77/70/64 samples in a 77-sample bucket, 5 channels,
    hops 20/19/17 and 35 windows: the last windows of each band clamp to
    its own T - Lb, and the lag range pads 153 lags to 256."""
    import torch
    from narrow_band_least_squares_tpu_torch.ops.kernels import fused_xcorr as FX

    Bg, C, T, Lg, W = 3, 5, 700, 77, 35
    lengths = np.array([77, 70, 64])
    pairs = np.array([(i, j) for i in range(C) for j in range(i + 1, C)], np.int32)
    tab = FX.precompute_fused_tables(Lg, pairs, C)
    g = torch.Generator(device="cuda").manual_seed(seed)
    bh = lengths - 1
    half = Lg - 1
    cuda = lambda a, dt: torch.as_tensor(np.asarray(a), dtype=dt, device="cuda")
    col = lambda v: cuda(np.asarray(v)[:, None], torch.int32)
    return (
        torch.randn(Bg, C, T, generator=g, device="cuda"),
        col([20, 19, 17]), col(T - lengths), col(half - bh), col(half + bh),
        cuda(np.arange(Lg)[None, :] < lengths[:, None], torch.float32),
        *(cuda(tab[k], torch.float32) for k in ("Cf", "Sf", "Ec", "Es")),
        cuda(pairs, torch.int32), W,
    )


def fused_pipeline(plan, rij, **kw):
    from narrow_band_least_squares_tpu_torch.models import NarrowBandPipeline

    return NarrowBandPipeline(plan, rij, filter_type="cheby1", alpha=1.0,
                              xcorr_method="fused", device="cuda", **kw)


def dense50_plan(st):
    """The 50-band plan (bench.py:345-347) on the canonical stream."""
    from narrow_band_least_squares_tpu_torch.utils import (
        get_freqlist, get_winlenlist, make_plan,
    )

    fl50, nb50, _ = get_freqlist(FMIN, FMAX, "log", 50)
    wl50 = get_winlenlist("adaptive", nb50, WINLEN, WINLEN_1, WINLEN_X)
    return make_plan(fl50, "log", wl50, WINOVER, st.npts, st.fs)


def phase_fused_kernel():
    """Every precision against its own plain version on the canonical
    buckets, the mixed-length bucket and the ragged random case, and a
    launch in several chunks against one; at 'highest' (the fp32 ring tile,
    whose K parts meet in a cluster) also every dense50 bucket, and chunks
    on every bucket.  Returns max |rho error| per precision."""
    import torch
    from narrow_band_least_squares_tpu_torch.io import synthetic_plane_wave
    from narrow_band_least_squares_tpu_torch.utils import get_rij, make_plan

    st, freqlist, winlens = canonical_inputs()
    plan = make_plan(freqlist, "log", winlens, WINOVER, st.npts, st.fs)
    rij = get_rij(st.latitudes, st.longitudes, st.nchans)
    pipe = fused_pipeline(plan, rij)
    canon = capture_fused_inputs(pipe, st.data)
    dense = capture_fused_inputs(fused_pipeline(dense50_plan(st), rij), st.data)
    # tests/test_xcorr_methods.py:457: one bucket of a 30 s and a 29 s band
    sm = synthetic_plane_wave(nchans=5, duration_s=300, fs=10.0, baz_deg=200.0,
                              trace_vel_kms=0.33, f0=0.6, bandwidth=0.8,
                              snr=10, seed=3)
    mplan = make_plan([0.3, 0.7, 1.4], "linear", [30, 29], 0.95, sm.npts, sm.fs)
    mpipe = fused_pipeline(mplan, get_rij(sm.latitudes, sm.longitudes, sm.nchans),
                           bucket_slack=4.0)
    Lg = max(wp.winlensamp for wp in mplan.windows)
    short = min(mplan.windows, key=lambda wp: wp.winlensamp)
    if len(mpipe._buckets) != 1 or short.starts[-1] <= mplan.npts - Lg:
        fail("the mixed-length fixture does not reach past T - Lg")
    mixed = capture_fused_inputs(mpipe, sm.data)[0]
    ragged = fused_random_case()
    errs = {}
    for prec in PRECISIONS:
        worst = 0.0
        for i, args in enumerate(canon):
            worst = max(worst, check_fused(f"canonical bucket {i}", args, prec)[0])
        worst = max(worst, check_fused("mixed-length bucket", mixed, prec)[0])
        worst = max(worst, check_fused("ragged-random", ragged, prec)[0])
        errs[prec] = worst
        if prec != "highest":
            check_fused_chunks("canonical bucket 0", canon[0], prec)
            check_fused_chunks("ragged-random", ragged, prec)
            continue
        for i, args in enumerate(dense):
            errs[prec] = max(errs[prec], check_fused(f"dense50 bucket {i}", args, prec)[0])
            torch.cuda.empty_cache()
        cases = ([(f"canonical bucket {i}", a) for i, a in enumerate(canon)]
                 + [(f"dense50 bucket {i}", a) for i, a in enumerate(dense)]
                 + [("mixed-length bucket", mixed), ("ragged-random", ragged)])
        for name, args in cases:
            check_fused_chunks(name, args, prec)
    return errs


def run_api_fused(st, freqlist, winlens, precision):
    """The canonical API run with xcorr_method='fused' on the card at
    ``matmul_precision``; returns (outputs, launches of the fp32 route,
    launches of the tensor-core route)."""
    import torch
    from narrow_band_least_squares_tpu_torch import api
    from narrow_band_least_squares_tpu_torch.ops.kernels import fused_xcorr as FX
    from narrow_band_least_squares_tpu_torch.ops.kernels import xcorr_peak as XP

    prev = api.set_performance_defaults(
        xcorr_method="fused",
        matmul_precision=None if precision == "high" else precision)
    try:
        FX.launches = FX.launches_tc = XP.launches = XP.launches_tc = 0
        t0 = time.perf_counter()
        out = run_api(st, freqlist, winlens, "cuda")
        torch.cuda.synchronize()
        t_first = time.perf_counter() - t0
        f32, tc, icorr = FX.launches, FX.launches_tc, XP.launches + XP.launches_tc
    finally:
        api.set_performance_defaults(xcorr_method=None, matmul_precision=None)
        api.set_performance_defaults(**prev)
    log(f"fused main path at {precision} (cuda, first call incl. host set-up): "
        f"{t_first:.3f} s, fused_xcorr_bucket launches: fp32 route {f32}, "
        f"tensor-core route {tc}; icorr_peak launches {icorr}")
    if icorr != 0:
        fail("the fused main path must launch no icorr_peak")
    return out, f32, tc


def phase_fused_main():
    """The canonical run with xcorr_method='fused' through the API: at the
    default 'high' only the tensor-core route, at 'highest' only the fp32
    route; both match the CPU run and the truth.  'default' takes the
    tensor-core route and must hit the truth.  Returns the main-path
    launches per precision."""
    st, freqlist, winlens = canonical_inputs()
    cpu = None
    launches = {}
    for prec in ("high", "highest", "default"):
        gpu, f32, tc = run_api_fused(st, freqlist, winlens, prec)
        own, other = (f32, tc) if prec == "highest" else (tc, f32)
        if own == 0 or other != 0:
            fail(f"the fused main path at {prec} must launch only the "
                 f"{'fp32' if prec == 'highest' else 'tensor-core'} route")
        launches[prec] = own
        ncl = gpu[6]
        check_shapes(gpu, ncl, NBANDS)
        if prec != "default":
            if cpu is None:
                from narrow_band_least_squares_tpu_torch import api

                prev = api.set_performance_defaults(xcorr_method="fused")
                try:
                    cpu = run_api(st, freqlist, winlens, "cpu")
                finally:
                    api.set_performance_defaults(xcorr_method=None)
                    api.set_performance_defaults(**prev)
            compare_outputs(gpu, cpu, ncl)
        ground_truth(gpu, ncl, label=f"fused {prec} ")
    return launches


# --------------------------------------------------------------------------
# multi-array and broadband
# --------------------------------------------------------------------------

def multiarray_inputs():
    """benchmarks/scaling.py:154-164: four 8-element arrays, baz 200-230."""
    from narrow_band_least_squares_tpu_torch.io import synthetic_plane_wave
    from narrow_band_least_squares_tpu_torch.utils import (
        get_freqlist, get_rij, get_winlenlist, make_plan,
    )

    streams = [synthetic_plane_wave(nchans=NCHANS, duration_s=DURATION_S, fs=FS,
                                    baz_deg=baz, trace_vel_kms=VEL_TRUE,
                                    seed=SEED + k)
               for k, baz in enumerate(MULTI_BAZ)]
    freqlist, nbands, _ = get_freqlist(FMIN, FMAX, "log", NBANDS)
    winlens = get_winlenlist("adaptive", nbands, WINLEN, WINLEN_1, WINLEN_X)
    plan = make_plan(freqlist, "log", winlens, WINOVER, streams[0].npts, FS)
    rijs = [get_rij(s.latitudes, s.longitudes, s.nchans) for s in streams]
    return plan, rijs, np.stack([s.data for s in streams])


def same_bits(a, b) -> bool:
    """Equal bit for bit, NaNs in the same places."""
    import torch

    if not a.is_floating_point():
        return torch.equal(a, b)
    return torch.equal(torch.isnan(a), torch.isnan(b)) and \
        torch.equal(torch.nan_to_num(a), torch.nan_to_num(b))


def phase_multiarray():
    import torch
    from narrow_band_least_squares_tpu_torch.models import (
        BroadbandPipeline, MultiArrayPipeline, NarrowBandPipeline,
    )
    from narrow_band_least_squares_tpu_torch.utils import get_rij

    plan, rijs, data = multiarray_inputs()
    ncl = plan.num_compute_list
    for method, prec in (("fused", "high"), ("fused", "highest"),
                         ("fused", "default"), ("mxu", "high")):
        kw = dict(xcorr_method=method, matmul_precision=prec, device="cuda")
        out = MultiArrayPipeline(plan, rijs, **kw).run_raw(data)
        torch.cuda.synchronize()
        worst = 0.0
        for k, rij in enumerate(rijs):
            one = NarrowBandPipeline(plan, rij, **kw).run_raw(data[k])
            for name, v in one.items():
                a, b = out[name][k], v
                if method == "fused":
                    if not same_bits(a, b):
                        fail(f"multiarray fused {prec}: array {k} {name} is not "
                             f"bit for bit the single-array run")
                    continue
                d = (a - b).abs().nan_to_num()
                worst = max(worst, float(d.max()))
                if bool((d > MULTI_TOL + MULTI_TOL * b.abs().nan_to_num()).any()):
                    fail(f"multiarray mxu: array {k} {name} differs from the "
                         f"single-array run beyond {MULTI_TOL}")
            res = tuple(out[n][k].cpu().numpy() for n in ("vel", "baz", "mdccm"))
            ground_truth(res, ncl, baz_true=MULTI_BAZ[k],
                         label=f"multiarray {method} {prec} array {k} ")
        log(f"multiarray {method} {prec}: A={len(rijs)} equals the single-array "
            "runs " + ("bit for bit" if method == "fused" else
                       f"within {MULTI_TOL} (max abs diff {worst:.3e})"))

    st, _, _ = canonical_inputs()
    rij = get_rij(st.latitudes, st.longitudes, st.nchans)
    runs = {}
    for dev in ("cuda", "cpu"):
        res = BroadbandPipeline(FMIN, FMAX, WINLEN, WINOVER, st.npts, st.fs, rij,
                                filter_type="cheby1", device=dev).run(st)
        runs[dev] = (res.vel_array, res.baz_array, res.mdccm_array, None, None,
                     res.sig_tau_array)
    bncl = res.num_compute_list
    check_shapes(runs["cuda"], bncl, 1)
    compare_outputs(runs["cuda"], runs["cpu"], bncl)
    ground_truth(runs["cuda"], bncl, label="broadband ")


# --------------------------------------------------------------------------
# sharded: the (time, band) mesh across processes
# --------------------------------------------------------------------------

SHARDED_TIMEOUT_S = 600   # per launch of the worker's ranks
SHARDED_PROCS = 4
SHARDED_MOVED_MAX = 0.002  # share of confident windows whose lag may move card vs CPU


def sharded_one_process(label, st, plan, rij):
    """(1) One process over NCCL at world size 1: ``run`` through the mesh
    code (the 1x1 device mesh, the all-gather) against the one-device
    pipeline, bit for bit with 'fused' and 'mxu', the same launches."""
    import torch
    import torch.distributed as dist
    from narrow_band_least_squares_tpu_torch.parallel import (
        ShardedNarrowBandPipeline, make_mesh,
    )
    from narrow_band_least_squares_tpu_torch.parallel.smoke import free_port

    dist.init_process_group("nccl", init_method=f"tcp://localhost:{free_port()}",
                            rank=0, world_size=1)
    try:
        mesh = make_mesh(1, 1)
        if not mesh.distributed or mesh.backend != "nccl":
            fail(f"sharded: the 1x1 mesh over NCCL is {mesh!r}")
        for method in ("fused", "mxu"):
            runs, counts = {}, {}
            for name, m in (("one device", None), ("mesh 1x1 nccl", mesh)):
                pipe = ShardedNarrowBandPipeline(plan, rij, m, xcorr_method=method,
                                                 device="cuda")
                segs = pipe.segment_stream(st.data)
                pipe.run(segs)
                torch.cuda.synchronize()
                zero_launches()
                t0 = time.perf_counter()
                runs[name] = pipe.run(segs)
                torch.cuda.synchronize()
                secs = time.perf_counter() - t0
                counts[name] = lag_search_launches()
                log(f"[{label}] sharded {method} {name}: run of {len(segs)} segments "
                    f"{secs:.4f} s; launches {counts[name]}")
            a, b = runs["one device"], runs["mesh 1x1 nccl"]
            for k in a:
                if not np.array_equal(a[k], b[k], equal_nan=True):
                    fail(f"sharded {method}: {k} through the 1x1 NCCL mesh is not bit "
                         "for bit the one-device pipeline")
            want = ((0, 0, 0, CANONICAL_BUCKETS) if method == "fused"
                    else (0, CANONICAL_BUCKETS, 0, 0))
            if counts["one device"] != counts["mesh 1x1 nccl"] or counts["one device"] != want:
                fail(f"sharded {method}: launches {counts}, expected {want} each")
            log(f"sharded {method}: the 1x1 NCCL mesh equals the one-device pipeline "
                f"bit for bit, {want} launches each")
    finally:
        dist.destroy_process_group()


def sharded_launch(label, name, nproc, *argv):
    """The worker's ranks on cuda:0 over gloo; logs each rank's stats and
    checks its launches.  Returns (stats, rank 0's npz)."""
    import shutil

    from narrow_band_least_squares_tpu_torch.parallel.smoke import launch

    outdir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                          "sharded_smoke")
    os.makedirs(outdir, exist_ok=True)
    out = os.path.join(outdir, name + ".npz")
    t0 = time.perf_counter()
    try:
        stats, _ = launch(nproc, [*argv, "--device", "cuda", "--backend", "gloo",
                                  "--out", out], timeout_s=SHARDED_TIMEOUT_S)
    except RuntimeError as e:
        fail(f"sharded {name}: {e}")
    secs = time.perf_counter() - t0
    method = argv[argv.index("--xcorr-method") + 1] if "--xcorr-method" in argv else "mxu"
    route = "fused_xcorr_bucket_tc" if method == "fused" else "icorr_peak_tc"
    for s in stats:
        log(f"[{label}] sharded {name} rank {s['rank']} (t={s['t']}, b={s['b']}): "
            f"wall {s['wall_s']:.4f} s; launches {s['launches']}; halo "
            f"{s.get('halo_bytes', 0)} B; gathered {s.get('gather_bytes', 0)} B; "
            f"gloo host copies {s['host_copy_bytes']} B in {s['host_copy_s']:.4f} s"
            + (f"; sequential oracle {s['sequential_s']:.3f} s, max abs diff "
               f"{s['max_abs_diff_sequential']:.3e}, bit for bit "
               f"{s['bit_for_bit_sequential']}" if "sequential_s" in s else ""))
        got = s["launches"]
        if got[route] == 0 or any(v for k, v in got.items() if k != route):
            fail(f"sharded {name} rank {s['rank']}: launches {got}, expected only {route}")
        if "batch" in s:
            want = s["buckets"] * -(-s["segments"] // s["batch"])
        else:
            want = s["buckets"]
        if got[route] != want:
            fail(f"sharded {name} rank {s['rank']}: {got[route]} {route} launches, "
                 f"predicted {want} (one per bucket a dispatch)")
    log(f"sharded {name}: {nproc} ranks on cuda:0 over gloo in {secs:.1f} s "
        "(process start-up included)")
    with np.load(out) as z:
        res = {k: z[k] for k in z.files}
    shutil.rmtree(outdir, ignore_errors=True)
    return stats, res


def sharded_against_cpu(name, st, plan, rij, res, segs, **kw):
    """Rank 0's assembled result on segments ``segs`` against the port's
    ``run_extended`` of the same segments on the CPU (halos cut from the
    stream): MdCCM within TOL on every valid window; vel/baz/sig_tau (and
    with LTS the flags) within TOL (equal) on every valid window whose P
    delays are bit-identical, at least LTS_SAME_MIN of them (a lag may move
    at a near-tie between 3xTF32 and fp32, as the lts phase rules), and at
    most SHARDED_MOVED_MAX of the confident windows with a moved lag; and
    the truth over every segment."""
    from narrow_band_least_squares_tpu_torch.parallel import ShardedNarrowBandPipeline
    from narrow_band_least_squares_tpu_torch.parallel.smoke import DelayRecorder

    cpu = ShardedNarrowBandPipeline(plan, rij, device="cpu", **kw)
    with DelayRecorder() as rec:
        ref = cpu.run_extended(cpu.extend_segments(st.data, [i * plan.npts for i in segs]))
    ncl = plan.num_compute_list
    n_same = n_valid = n_conf = moved_conf = 0
    worst = 0.0
    for k, i in enumerate(segs):
        for b, n in enumerate(ncl):
            same = (res["out_tau"][i, b, :n] == rec.taus[k][b, :n]).all(-1)
            n_same += int(same.sum())
            n_valid += n
            conf = ref["mdccm"][k, b, :n] > MDCCM_THRESH
            n_conf += int(conf.sum())
            moved_conf += int((~same & conf).sum())
            for nm in ("vel", "baz", "sig_tau", "mdccm"):
                g, c = res["out_" + nm][i, b, :n], ref[nm][k, b, :n]
                d = (np.abs((g - c + 180.0) % 360.0 - 180.0) if nm == "baz"
                     else np.abs(g - c))
                lim = TOL + TOL * np.abs(c)
                ok = (d <= lim) | (np.isnan(g) & np.isnan(c))
                held = np.ones(n, bool) if nm == "mdccm" else same
                if not ok[held].all():
                    fail(f"sharded {name} segment {i} band {b}: {nm} differs from the "
                         f"CPU beyond {TOL} on {int((~ok & held).sum())} windows")
                if held.any():
                    worst = max(worst, float(np.nanmax((d / lim)[held])))
            if "flags" in ref:
                fg, fc = res["out_flags"][i, b, :n], ref["flags"][k, b, :n]
                if not np.array_equal(fg[same], fc[same]):
                    fail(f"sharded {name} segment {i} band {b}: LTS flags differ from "
                         "the CPU on windows with bit-identical delays")
    share = n_same / n_valid
    log(f"sharded {name} segments {list(segs)} cuda vs cpu: {n_same}/{n_valid} = "
        f"{share:.4f} valid windows with bit-identical delays; {moved_conf}/{n_conf} "
        f"confident windows whose lag moved; MdCCM on all and vel/baz/sig_tau"
        f"{' and flags' if 'flags' in ref else ''} on those within {TOL} "
        f"(worst |d|/tol {worst:.3f})")
    if share < LTS_SAME_MIN:
        fail(f"sharded {name}: fewer than {LTS_SAME_MIN:.0%} of the valid windows have "
             "bit-identical delays on the card and the CPU")
    if moved_conf > SHARDED_MOVED_MAX * n_conf:
        fail(f"sharded {name}: the lag moved on {moved_conf} of {n_conf} confident "
             f"windows between the card and the CPU, more than {SHARDED_MOVED_MAX:.1%}")
    S = res["out_vel"].shape[0]
    cat = [np.zeros((plan.nbands, S * max(ncl))) for _ in range(3)]
    for b, n in enumerate(ncl):
        for j, key in enumerate(("vel", "baz", "mdccm")):
            cat[j][b, :S * n] = np.concatenate([res["out_" + key][s, b, :n]
                                                for s in range(S)])
    ground_truth(cat, [S * n for n in ncl], label=f"sharded {name} ")


def monitor_against_batched(res, ref):
    """The ranks' monitor against the one-process monitor in batches of
    MONITOR_DISPATCH segments: MdCCM within TOL on every valid window,
    vel and baz within TOL on at least LTS_SAME_MIN of them (the forward
    DFT's rounding, and so a lag at a near-tie, moves with the batch's row
    count: ROADMAP Queue 3)."""
    vel, baz, mdccm, _, num = ref
    n_ok = n_valid = 0
    worst = 0.0
    for b, n in enumerate(num):
        d = np.abs(res["mon_mdccm"][b, :n] - mdccm[b, :n])
        if (d > TOL + TOL * np.abs(mdccm[b, :n])).any():
            fail(f"sharded monitor band {b}: MdCCM differs from the one-process monitor "
                 f"in batches of {MONITOR_DISPATCH} beyond {TOL} ({float(d.max()):.3e})")
        ok = np.ones(n, bool)
        for key, c in (("mon_vel", vel[b, :n]), ("mon_baz", baz[b, :n])):
            g = res[key][b, :n]
            d = np.abs((g - c + 180.0) % 360.0 - 180.0) if key == "mon_baz" else np.abs(g - c)
            ok &= d <= TOL + TOL * np.abs(c)
            worst = max(worst, float(d.max(initial=0.0)))
        n_ok += int(ok.sum())
        n_valid += n
    share = n_ok / n_valid
    log(f"sharded monitor 4x1 against one process in batches of {MONITOR_DISPATCH}: "
        f"MdCCM within {TOL} on all {n_valid} valid windows, vel and baz on {n_ok} = "
        f"{share:.4f} of them (largest difference {worst:.3e})")
    if share < LTS_SAME_MIN:
        fail(f"sharded monitor: vel/baz within {TOL} of the one-process monitor in "
             f"batches of {MONITOR_DISPATCH} on fewer than {LTS_SAME_MIN:.0%} of the "
             "valid windows")


def phase_sharded(label):
    """(1) world size 1 over NCCL; (2) the worker's ranks on cuda:0 over
    gloo: (4, 1) 'fused', (2, 2) dense50 'mxu', (2, 2) LTS; (3) the monitor
    on four ranks; (4) MultiArrayPipeline on (time=2)."""
    import shutil

    from narrow_band_least_squares_tpu_torch.models import StreamingMonitor
    from narrow_band_least_squares_tpu_torch.parallel import auto_mesh_shape
    from narrow_band_least_squares_tpu_torch.parallel.smoke import inputs

    log(f"[{label}] sharded phase")
    st, plan, rij, freqlist = inputs("canonical")
    sharded_one_process(label, st, plan, rij)

    _, res = sharded_launch(label, "fused 4x1", SHARDED_PROCS, "--mesh-time", "4",
                            "--xcorr-method", "fused", "--workload", "canonical")
    sharded_against_cpu("fused 4x1", st, plan, rij, res, (0, 4, 15), xcorr_method="fused")

    if auto_mesh_shape(SHARDED_PROCS, 50) != (2, 2):
        fail(f"auto_mesh_shape({SHARDED_PROCS}, 50) is not (2, 2)")
    st50, plan50, rij50, _ = inputs("dense50")
    _, res = sharded_launch(label, "mxu dense50 2x2", SHARDED_PROCS, "--mesh-time", "2",
                            "--mesh-band", "2", "--workload", "dense50")
    sharded_against_cpu("mxu dense50 2x2", st50, plan50, rij50, res, (0, 8, 15))

    stl, planl, rijl, _ = inputs("canonical", LTS_ALPHA, MONITOR_LTS_HOURS)
    stats, res = sharded_launch(label, "lts 2x2", SHARDED_PROCS, "--mesh-time", "2",
                                "--mesh-band", "2", "--alpha", str(LTS_ALPHA),
                                "--workload", "canonical", "--hours",
                                str(MONITOR_LTS_HOURS))
    log(f"sharded lts 2x2: flags equal the oracle's on every window with "
        f"bit-identical delays ({stats[0]['lts_same_delay_share']:.4f} of them)")
    sharded_against_cpu("lts 2x2", stl, planl, rijl, res, (0, 3, 5), alpha=LTS_ALPHA)

    workdir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                           "sharded_monitor")
    shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(os.path.join(workdir, "ranks"))
    _, res = sharded_launch(label, "monitor 4x1", SHARDED_PROCS, "--mesh-time", "4",
                            "--workload", "canonical", "--monitor-dir",
                            os.path.join(workdir, "ranks"))
    # each rank steps one segment a dispatch: the one-process monitor with
    # batches of one computes the same shapes, so the same bits
    ones = {}
    for batch in (1, MONITOR_DISPATCH):
        with StreamingMonitor(plan, rij, os.path.join(workdir, f"one-{batch}"), freqlist,
                              dispatch_segments=batch, device="cuda") as mon:
            mon.process(st)
        ones[batch] = mon.read_all()
        if (not np.array_equal(res["mon_num"], ones[batch][4])
                or not np.array_equal(res["mon_t"], ones[batch][3])):
            fail(f"sharded monitor: window counts or times differ from the one-process "
                 f"monitor in batches of {batch}")
    for key, ref in zip(("mon_vel", "mon_baz", "mon_mdccm"), ones[1][:3]):
        if not np.array_equal(res[key], ref):
            fail(f"sharded monitor: {key} is not bit for bit the one-process monitor's "
                 f"in batches of one (max abs diff {float(np.abs(res[key] - ref).max()):.3e})")
    monitor_against_batched(res, ones[MONITOR_DISPATCH])
    log("sharded monitor 4x1: rank 0 alone wrote, resumed, redid a deleted segment "
        "alone; bit for bit the one-process monitor with batches of one segment")
    shutil.rmtree(workdir, ignore_errors=True)

    sharded_launch(label, "multiarray 2x1", 2, "--multiarray", "--mesh-time", "2",
                   "--xcorr-method", "fused", "--workload", "canonical")
    log("sharded multiarray 2x1: each array bit for bit its single-array run")


# --------------------------------------------------------------------------
# LTS
# --------------------------------------------------------------------------

class LtsRecorder:
    """While installed (``with``), records the delays (B, Wmax, P) every LTS
    solve of the port receives, and the lags beside them where the pipeline
    passes them (the one-band programs), as NumPy arrays.  It wraps
    ``ops.lts.lts_solve`` and launches nothing of its own."""

    def __enter__(self):
        from narrow_band_least_squares_tpu_torch.ops import lts as LTS

        self.taus, self.lags, self._mod, self._real = [], [], LTS, LTS.lts_solve

        def rec(tau, *args, **kw):
            self.taus.append(tau.detach().cpu().numpy().copy())
            lag = kw.get("lag")
            self.lags.append(None if lag is None else lag.detach().cpu().numpy().copy())
            return self._real(tau, *args, **kw)

        LTS.lts_solve = rec
        return self

    def __exit__(self, *exc):
        self._mod.lts_solve = self._real


def lag_search_launches():
    """(icorr_peak fp32, icorr_peak tensor-core, fused_xcorr_bucket fp32,
    fused_xcorr_bucket tensor-core) launch counts."""
    from narrow_band_least_squares_tpu_torch.ops.kernels import fused_xcorr as FX
    from narrow_band_least_squares_tpu_torch.ops.kernels import xcorr_peak as XP

    return XP.launches, XP.launches_tc, FX.launches, FX.launches_tc


def zero_launches():
    from narrow_band_least_squares_tpu_torch.ops.kernels import fused_xcorr as FX
    from narrow_band_least_squares_tpu_torch.ops.kernels import lts_sweep as LS
    from narrow_band_least_squares_tpu_torch.ops.kernels import xcorr_peak as XP

    XP.launches = XP.launches_tc = FX.launches = FX.launches_tc = 0
    XP.launches_nb = XP.launches_nb_tc = 0
    LS.launches_residuals2 = LS.launches_refit = LS.launches_elemental = 0
    LS.launches_residuals2_lag = LS.launches_sweep = LS.launches_sweep_thread = 0
    LS.launches_final = 0


def lts_sweep_launches():
    """{entry point: launches} of the LTS sweep's kernels (csrc/lts_sweep.cu);
    "sweep_thread" counts those of `sweep`'s launches on its thread route."""
    from narrow_band_least_squares_tpu_torch.ops.kernels import lts_sweep as LS

    return {"sweep": LS.launches_sweep, "sweep_thread": LS.launches_sweep_thread,
            "residuals2": LS.launches_residuals2,
            "refit": LS.launches_refit, "elemental": LS.launches_elemental,
            "residuals2_lag": LS.launches_residuals2_lag, "final": LS.launches_final}


class EagerRanks:
    """While installed (``with``), counts the calls of the eager rank
    (`ops.kernels.lts_sweep.rank_along_last`, a (rows, P, P) comparison
    tensor): on the card none at P <= 64, where the candidate sweep ranks
    inside `lts_sweep.sweep` and the final subset inside `lts_sweep.final`;
    above, the final subset's (`ops.lts._final_passes`), one a solve."""

    def __enter__(self):
        from narrow_band_least_squares_tpu_torch.ops.kernels import lts_sweep as LS

        self.calls, self._mod, self._real = 0, LS, LS.rank_along_last

        def counted(*args, **kw):
            self.calls += 1
            return self._real(*args, **kw)

        LS.rank_along_last = counted
        return self

    def __exit__(self, *exc):
        self._mod.rank_along_last = self._real


def run_api_lts(st, freqlist, winlens, device, production):
    """The canonical API run at ALPHA = LTS_ALPHA on ``device``, exhaustive
    or with ``PRODUCTION_DEFAULTS``; returns (outputs, delays, seconds of
    the first call, host set-up included, the LTS sweep's launches).  On
    the card the run must launch icorr_peak's tensor-core route once per
    bucket and nothing else of the lag search ('mxu' at 'high'), and of
    csrc/lts_sweep.cu the candidate sweep in one `sweep` launch (two with
    the funnel of PRODUCTION_DEFAULTS), each on its thread route (P = 28),
    one elemental launch and the final subset in one `final` launch; no
    residuals2, refit or residuals2_lag launch and no eager rank (the
    8-band program fuses no delay into the sweep)."""
    import torch
    from narrow_band_least_squares_tpu_torch import api

    prev = api.set_performance_defaults(**(api.PRODUCTION_DEFAULTS if production else {}))
    try:
        with LtsRecorder() as rec, EagerRanks() as ranks:
            zero_launches()
            t0 = time.perf_counter()
            out = run_api(st, freqlist, winlens, device, alpha=LTS_ALPHA)
            if device == "cuda":
                torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            counts = lag_search_launches()
            sweep = lts_sweep_launches()
    finally:
        api.set_performance_defaults(**{k: None for k in api.PRODUCTION_DEFAULTS})
        api.set_performance_defaults(**prev)
    if len(rec.taus) != 1:
        fail(f"the LTS API run solved {len(rec.taus)} times, not once")
    if device == "cuda":
        log(f"LTS API run ({'production' if production else 'exhaustive'}): "
            f"icorr_peak launches fp32 route {counts[0]}, tensor-core route "
            f"{counts[1]}; fused_xcorr_bucket {counts[2] + counts[3]}; lts_sweep "
            f"{sweep}; eager ranks {ranks.calls}")
        if counts != (0, CANONICAL_BUCKETS, 0, 0):
            fail(f"the LTS API run on the card must launch only icorr_peak's "
                 f"tensor-core route, once per bucket ({CANONICAL_BUCKETS}); "
                 f"launches {counts}")
        want = {"sweep": 2 if production else 1, "sweep_thread": 2 if production else 1,
                "residuals2": 0, "refit": 0, "elemental": 1, "residuals2_lag": 0,
                "final": 1}
        if sweep != want or ranks.calls != 0:
            fail(f"the LTS API run on the card (one solve) must launch lts_sweep "
                 f"{want} and rank nothing eagerly; got {sweep}, {ranks.calls} eager "
                 f"ranks")
    elif any(sweep.values()):
        fail(f"the LTS API run on the CPU launched lts_sweep kernels: {sweep}")
    return out, rec.taus[0], secs, sweep


def compare_lts(gpu, cpu, tau_g, tau_c, ncl, label):
    """The card's stdict equal to the CPU's, and vel/baz/sig_tau within TOL,
    on every valid window whose P delays are bit-identical between the two
    runs; those windows are at least LTS_SAME_MIN of the valid ones."""
    keys = [k for k in cpu[4] if k != "size"]
    if [k for k in gpu[4] if k != "size"] != keys or gpu[4]["size"] != cpu[4]["size"]:
        fail(f"{label}: the card's stdict keys differ from the CPU's")
    same = (tau_g == tau_c).all(-1)
    i = n_same = 0
    worst = 0.0
    for b, n in enumerate(ncl):
        for w in range(n):
            key, i = keys[i], i + 1
            if not same[b, w]:
                continue
            n_same += 1
            g_el, c_el = np.asarray(gpu[4][key]), np.asarray(cpu[4][key])
            if not np.array_equal(g_el, c_el):
                fail(f"{label}: band {b} window {w} has bit-identical delays but "
                     f"the card flags elements {g_el.tolist()}, the CPU "
                     f"{c_el.tolist()}")
            for col, nm in ((0, "vel"), (1, "baz"), (5, "sig_tau")):
                g, c = gpu[col][b, w], cpu[col][b, w]
                d = abs((g - c + 180.0) % 360.0 - 180.0) if nm == "baz" else abs(g - c)
                if np.isnan(g) and np.isnan(c):
                    continue
                worst = max(worst, d / (TOL + TOL * abs(c)))
                if not d <= TOL + TOL * abs(c):
                    fail(f"{label}: band {b} window {w} {nm} differs beyond {TOL} "
                         f"(cuda {g}, cpu {c})")
    share = n_same / len(keys)
    log(f"{label} cuda vs cpu: {n_same}/{len(keys)} = {share:.4f} valid windows "
        f"with bit-identical delays; on all of them equal flags and "
        f"vel/baz/sig_tau within {TOL} (worst |d|/tol {worst:.3f})")
    if share < LTS_SAME_MIN:
        fail(f"{label}: fewer than {LTS_SAME_MIN:.0%} of the valid windows have "
             f"bit-identical delays on the card and the CPU")


def check_outlier(stdict, nchans, outlier, label):
    counts = np.zeros(nchans + 1, dtype=np.int64)
    for k, v in stdict.items():
        if k != "size":
            np.add.at(counts, np.asarray(v, dtype=np.int64), 1)
    log(f"{label}: stdict flags per element (1-based) {counts[1:].tolist()}")
    if counts.argmax() != outlier + 1:
        fail(f"{label}: element {counts.argmax()} is the most flagged, not the "
             f"outlier {outlier + 1}")


def lts_multiarray():
    """Four merged arrays with 'fused' at 'high' equal their single-array
    runs bit for bit, flags included."""
    from narrow_band_least_squares_tpu_torch.models import (
        MultiArrayPipeline, NarrowBandPipeline,
    )

    import torch

    plan, rijs, data = multiarray_inputs()
    kw = dict(alpha=LTS_ALPHA, xcorr_method="fused", matmul_precision="high",
              device="cuda")
    multi = MultiArrayPipeline(plan, rijs, **kw)
    zero_launches()
    out = multi.run_raw(data)
    torch.cuda.synchronize()
    counts = lag_search_launches()
    batches = -(-len(rijs) // multi.merge_chunk_arrays)
    log(f"lts multiarray fused high: fused_xcorr_bucket launches fp32 route "
        f"{counts[2]}, tensor-core route {counts[3]} ({batches} merged batches x "
        f"{CANONICAL_BUCKETS} buckets); icorr_peak {counts[0] + counts[1]}")
    if counts[:3] != (0, 0, 0) or counts[3] < batches * CANONICAL_BUCKETS:
        fail(f"the merged LTS run must launch only fused_xcorr_bucket's "
             f"tensor-core route, at least once per bucket of each merged batch; "
             f"launches {counts}")
    for k, rij in enumerate(rijs):
        one = NarrowBandPipeline(plan, rij, **kw).run_raw(data[k])
        for name, v in one.items():
            if not same_bits(out[name][k], v):
                fail(f"lts multiarray: array {k} {name} is not bit for bit the "
                     f"single-array run")
        res = tuple(out[n][k].cpu().numpy() for n in ("vel", "baz", "mdccm"))
        ground_truth(res, plan.num_compute_list, baz_true=MULTI_BAZ[k],
                     label=f"lts multiarray array {k} ")
    log(f"lts multiarray fused high: A={len(rijs)} equals the single-array runs "
        f"bit for bit, flags included ({int(out['flags'].sum())} flagged pairs)")


# tests/test_large_array.py:27-38: 16 elements (P = 120, 7,140 candidates),
# element 12 (1-based) incoherent
LTS_LARGE_STREAM = dict(nchans=16, duration_s=160.0, fs=10.0, baz_deg=285.0,
                        trace_vel_kms=0.33, f0=0.6, bandwidth=0.8, snr=12.0,
                        aperture_km=3.0, seed=5, outlier_channels=(11,))


def lts_large_array():
    """tests/test_large_array.py:27-38 at 16 elements (P = 120, 7,140
    candidates): the automatic chunk of 4096 equals a chunk of 1024 bit for
    bit, the run sweeps each chunk in one lts_sweep.sweep launch (the block
    route) and ranks eagerly only the final subset, and the outlier element
    is the most flagged on confident windows."""
    import torch
    from narrow_band_least_squares_tpu_torch.io import synthetic_plane_wave
    from narrow_band_least_squares_tpu_torch.models import NarrowBandPipeline
    from narrow_band_least_squares_tpu_torch.utils import (
        get_freqlist, get_rij, get_winlenlist, make_plan,
    )

    outlier = LTS_LARGE_STREAM["outlier_channels"][0]
    st = synthetic_plane_wave(**LTS_LARGE_STREAM)
    freqlist, nbands, _ = get_freqlist(0.3, 1.2, "log", 2)
    winlens = get_winlenlist("constant", nbands, 30, 0, 0)
    plan = make_plan(freqlist, "log", winlens, 0.5, st.npts, st.fs)
    rij = get_rij(st.latitudes, st.longitudes, st.nchans)
    auto = NarrowBandPipeline(plan, rij, alpha=LTS_ALPHA, device="cuda")
    Q = auto.state_dict()["cand"].shape[0]
    if Q != 7140 or auto.lts_candidate_chunk != 4096:
        fail(f"lts large array: {Q} candidates in chunks of "
             f"{auto.lts_candidate_chunk}, not 7140 in chunks of 4096")
    with LtsRecorder() as rec, EagerRanks() as ranks:
        zero_launches()
        t0 = time.perf_counter()
        a = auto.run_raw(st.data)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    counts, sweep = lag_search_launches(), lts_sweep_launches()
    if counts[0] or counts[2:] != (0, 0) or not counts[1]:
        fail(f"lts large array: the run must launch only icorr_peak's tensor-core "
             f"route; launches {counts}")
    chunks = -(-Q // auto.lts_candidate_chunk)
    want = {"sweep": chunks, "sweep_thread": 0, "residuals2": 2, "refit": 1,
            "elemental": chunks, "residuals2_lag": 0, "final": 0}
    if (len(rec.taus), sweep, ranks.calls) != (1, want, 1):
        fail(f"lts large array: one solve must launch {want} (sweep once a chunk on the "
             f"block route, the final subset on the separate passes) and rank eagerly "
             f"once; {len(rec.taus)} solves, launches {sweep}, {ranks.calls} eager ranks")
    b = NarrowBandPipeline(plan, rij, alpha=LTS_ALPHA, lts_candidate_chunk=1024,
                           device="cuda").run_raw(st.data)
    for name, v in a.items():
        if not same_bits(v, b[name]):
            fail(f"lts large array: {name} with chunks of 4096 differs from "
                 f"chunks of 1024")
    good = (a["mdccm"] > 0.4).cpu().numpy()
    flags = a["flags"].cpu().numpy()[good]
    counts = np.zeros(16, dtype=np.int64)
    for p, (i, j) in enumerate(auto.pairs_np):
        counts[i] += flags[:, p].sum()
        counts[j] += flags[:, p].sum()
    log(f"lts large array: P=120, Q={Q}, {plan.nbands} x {plan.max_windows} "
        f"windows, first step {secs:.3f} s; lts_sweep launches {sweep} (one sweep a "
        f"chunk); chunks of 4096 and 1024 equal bit for "
        f"bit; flags per element on {int(good.sum())} confident windows "
        f"{counts.tolist()}")
    if counts.argmax() != outlier:
        fail(f"lts large array: element {counts.argmax()} is the most flagged, not "
             f"{outlier}")
    return sweep


def lts_one_band_large(label, device="cuda"):
    """One-band ltsva on `lts_large_array`'s 16-element stream (P = 120,
    7,140 candidates in two chunks of 4096), band-passed to 0.3-1.2 Hz: its
    final subset takes the separate passes (P > 64), with the lags at the
    "final" and "sigma2" sites (`delay_contracted`, chunked), so on the card
    it must launch sweep and elemental once a chunk (block route), two
    residuals2_lag, one refit, no final and no residuals2, and rank eagerly
    once; element 12 (1-based), the incoherent one, the most flagged.
    Returns the launches."""
    import torch
    from narrow_band_least_squares_tpu_torch import api
    from narrow_band_least_squares_tpu_torch.io import synthetic_plane_wave

    big = synthetic_plane_wave(**LTS_LARGE_STREAM)
    stf, _, _ = api.filter_data(big, "cheby1", 0.3, 1.2, 2, 0.01, device="cpu")
    first_call()
    with LtsRecorder() as rec, EagerRanks() as ranks:
        zero_launches()
        out = api.ltsva(stf, stf.latitudes, stf.longitudes, 30.0, 0.5, LTS_ALPHA,
                        device=device)
        if device == "cuda":
            torch.cuda.synchronize()
        sweep = lts_sweep_launches()
    want = {"sweep": 2, "sweep_thread": 0, "residuals2": 0, "refit": 1, "elemental": 2,
            "residuals2_lag": 2, "final": 0}
    if device == "cuda" and (len(rec.taus), rec.lags[0] is not None, sweep,
                             ranks.calls) != (1, True, want, 1):
        fail(f"one-band ltsva at P = 120: one solve with the lags must launch {want} and "
             f"rank eagerly once; {len(rec.taus)} solves, launches {sweep}, "
             f"{ranks.calls} eager ranks")
    if not all(np.isfinite(out[k]).all() for k in (0, 1, 5)):
        fail("one-band ltsva at P = 120: vel, baz or sig_tau not finite")
    check_outlier(out[4], 16, LTS_LARGE_STREAM["outlier_channels"][0],
                  "one-band ltsva at P = 120")
    log(f"[{label}] one-band ltsva at P = 120 ({len(out[0])} windows of 30 s, 7140 "
        f"candidates in chunks of 4096): lts_sweep launches {sweep}, {ranks.calls} eager "
        f"rank (the final subset's separate passes, with the lags)")
    return sweep


def rank_reference(x, rows=50_000):
    """The rank's definition, pair by pair, in chunks of ``rows`` rows:
    x_j counts against x_i when x_j < x_i, or x_j == x_i and j < i (NaN as
    +inf)."""
    import torch

    x = torch.where(torch.isnan(x), torch.full_like(x, float("inf")), x)
    P = x.shape[-1]
    flat = x.reshape(-1, P)
    idx = torch.arange(P, device=x.device)
    before = idx[None, :] < idx[:, None]
    out = torch.empty(flat.shape, dtype=torch.int64, device=x.device)
    for r0 in range(0, flat.shape[0], rows):
        xi, xj = flat[r0:r0 + rows, :, None], flat[r0:r0 + rows, None, :]
        out[r0:r0 + rows] = torch.where(before, xj <= xi, xj < xi).sum(-1)
    return out.reshape(x.shape)


def lts_rank_check(label, st, freqlist, winlens):
    """The sweep's rank (`ops.lts._rank_along_last`) equals its pairwise
    definition on the card, exactly, on the canonical sweep's squared
    residuals after one C-step (632 windows x 378 candidates x 28) and on
    values with many exact ties, NaN, infs and signed zeros; both timed."""
    import torch
    from narrow_band_least_squares_tpu_torch.models import NarrowBandPipeline
    from narrow_band_least_squares_tpu_torch.ops import lts as LTS
    from narrow_band_least_squares_tpu_torch.utils import get_rij, make_plan

    plan = make_plan(freqlist, "log", winlens, WINOVER, st.npts, st.fs)
    pipe = NarrowBandPipeline(plan, get_rij(st.latitudes, st.longitudes, st.nchans),
                              alpha=LTS_ALPHA, device="cuda")
    g = pipe._geometry
    tau = pipe._delays(pipe._filter(pipe._to_device(st.data)))[0]
    _, s = LTS._candidate_sweep(tau, g["X"], g["cand"], g["Ainv"], g["cand_ok"],
                                pipe.h, 1)
    r2 = LTS._residuals2(tau, g["X"], s)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    ties = torch.randint(-3, 6, r2.shape, generator=gen, device="cuda").float() * 0.25
    u = torch.rand(r2.shape, generator=gen, device="cuda")
    ties[u < 0.05] = float("nan")
    ties[(u >= 0.05) & (u < 0.08)] = float("inf")
    ties[(u >= 0.08) & (u < 0.1)] = float("-inf")
    ties[(ties == 0) & (u < 0.5)] = -0.0
    for name, x in (("canonical residuals", r2), ("ties", ties)):
        got, want = LTS._rank_along_last(x), rank_reference(x)
        if not torch.equal(got.long(), want):
            fail(f"lts rank on {name}: {int((got.long() != want).sum())} ranks differ "
                 f"from the pairwise definition")
        ms = device_ms(lambda: LTS._rank_along_last(x), reps=5)
        ref_ms = device_ms(lambda: rank_reference(x), reps=5)
        log(f"[{label}] lts rank on {name} {tuple(x.shape)}: equal to its pairwise "
            f"definition; {ms:.4f} ms (the pairwise reference, rank_reference: "
            f"{ref_ms:.4f} ms)")


def profile_once(fn):
    """Device ms of one call of ``fn`` (sum of every kernel and copy
    torch.profiler saw) and its largest rows."""
    busy, rows = device_profile(fn)
    return busy * 1e3, rows


def lts_timing(label, st):
    """Canonical and dense50 (the LTS input): the OLS step, and per LTS
    pipeline (exhaustive, lts_funnel_k='auto') by the "sweep" route (the
    final subset on the separate passes) and the "final" route
    (`SweepRoute`) in turns (sweep, final, final, sweep): the step by CUDA
    events over 20 steps after warm-up, its peak memory, and the solve's
    device time and kernel count in one profiled solve."""
    import torch
    from narrow_band_least_squares_tpu_torch.models import NarrowBandPipeline
    from narrow_band_least_squares_tpu_torch.utils import get_rij, make_plan

    rij = get_rij(st.latitudes, st.longitudes, st.nchans)
    _, freqlist, winlens = canonical_inputs()
    plans = {"canonical": make_plan(freqlist, "log", winlens, WINOVER, st.npts, st.fs),
             "dense50": dense50_plan(st)}

    def step_line(pipe):
        ms = cuda_time_ms(lambda: pipe.run_raw(st.data), reps=20)
        peak, base = step_peak_mib(lambda: pipe.run_raw(st.data))
        return (f"{ms:.4f} ms per run_raw step (CUDA events, 20 steps), peak memory "
                f"{peak + base:.1f} MiB ({peak:.1f} MiB above the {base:.1f} MiB held "
                f"before the step)")

    for name, plan in plans.items():
        rows = plan.nbands * plan.max_windows
        pipe = NarrowBandPipeline(plan, rij, filter_type="cheby1", device="cuda", alpha=1.0)
        log(f"[{label}] {name} OLS: {step_line(pipe)}")
        for tag, kw in (("LTS exhaustive", {}), ("LTS auto", dict(lts_funnel_k="auto"))):
            pipe = NarrowBandPipeline(plan, rij, filter_type="cheby1", device="cuda",
                                      alpha=LTS_ALPHA, **kw)
            Q = pipe.state_dict()["cand"].shape[0]
            tau, _, md = pipe._delays(pipe._filter(pipe._to_device(st.data)))
            for route in ("sweep", "final", "final", "sweep"):
                with SweepRoute(route):
                    line = step_line(pipe)
                    pipe._solve_masked(tau, md)
                    busy, top = profile_once(lambda: pipe._solve_masked(tau, md))
                log(f"[{label}] {name} {tag} (sweep route {route}): {line}; solve ({rows} "
                    f"windows x {Q} candidates, funnel {pipe.lts_funnel_k}) {busy:.4f} ms of "
                    f"device time in one profiled solve, {sum(r[2] for r in top)} kernels; "
                    f"largest: " + "; ".join(f"{us / 1e3:.4f} ms x{c} {k[:60]}"
                                             for us, k, c in top[:4]))
            del pipe
            torch.cuda.empty_cache()


LTS_SWEEP_SOURCE = "narrow_band_least_squares_tpu_torch/csrc/lts_sweep.cu"
# What each entry point replaces: XLA's compiled arithmetic, no TPU kernel.
LTS_SWEEP_REPLACES = {
    "sweep": "none: the port's own kernel for XLA's compiled C-steps and trimmed "
             "objective, narrow_band_least_squares_tpu/ops/lts.py:96 (_c_steps) "
             "and :110 (_trimmed_objective)",
    "residuals2": "none: the port's own kernel for XLA's contracted einsum at "
                  "narrow_band_least_squares_tpu/ops/lts.py:92 (and :224, :230)",
    "refit": "none: the port's own kernel for XLA's contracted trees of "
             "narrow_band_least_squares_tpu/ops/solve.py:196 (masked_refit)",
    "elemental": "none: the port's own kernel for XLA's contracted einsum at "
                 "narrow_band_least_squares_tpu/ops/lts.py:132",
    "residuals2_lag": "none: the port's own kernel for XLA's delays fused and "
                      "contracted into narrow_band_least_squares_tpu/ops/lts.py:92 "
                      "(and :224, :230) in the one-band programs",
    "final": "none: the port's own kernel for XLA's compiled final subset, "
             "narrow_band_least_squares_tpu/ops/lts.py:209-221 (the first minimum) and "
             ":223-261 (ranks, masked_refit, sigma_tau, the uncertainty ellipse)",
}
# The capped-candidate stream on which the port and the JAX package once kept
# different subsets (ROADMAP.md Queue 3, fixed): 4 log bands over 0.2-1.6 Hz,
# adaptive 30/40/20 s windows, max_lts_candidates = 5.
LTS_CAPPED_STREAM = dict(nchans=6, duration_s=300.0, fs=10.0, baz_deg=200.0,
                         trace_vel_kms=0.33, f0=0.6, bandwidth=0.8, snr=10.0, seed=3,
                         outlier_channels=(2,))


# Compares a second of one H100 SXM: 64 an SM a clock, the rate of the
# SM's 64 INT32 lanes (the Hopper architecture white paper), on whose pipe
# integer and float compares issue, x 132 SMs x 1.98 GHz.
PEAK_COMPARES = 64 * 132 * 1.98e9


def lts_sweep_work(name, rows, Q, P, itemsize=4, n_steps=4, objective=True, roles=0):
    """(operations, bytes) of one launch of an lts_sweep entry point: each
    input read once, each output written once, float operations counted as
    written in csrc/lts_sweep.cu (a fused multiply-add as two).  For
    "sweep" the operations are (float, compares): the ranks of a rank pass
    (n_steps, and one for the objective) need P (P - 1) / 2 key
    comparisons, each unordered pair once (the ranked keys and those they
    are counted against one, as on every multi-band path).  For "final"
    (Q the candidates a window) too: the first minimum's Q - 1 comparisons
    and one rank pass; its bytes are obj, the minimum's fit, tau, X (and
    the lags under ``roles``) read once, the five values a window and a
    byte of retained an equation written once."""
    half = 1 << max(P - 1, 0).bit_length() >> 1
    if name == "final":           # rows windows: the minimum over Q, the final subset
        tree = P + (P - half) + 2 * half + (half - 1)   # as the refit's
        # two residual passes, the refit, the leaves w r2 and (w X_a) X_b,
        # the four sums' trees, the ellipse in lane 0
        per = 10 * P + 5 * tree + 12 + 6 * P + 4 * max(2 * half - 1, 0) + 41
        cmps = rows * (Q - 1 + P * (P - 1) // 2)
        nbytes = (itemsize * (rows * Q + 2 * rows + rows * P + 2 * P + 6 * rows) + rows * P
                  + (4 * rows * P if roles else 0))
        return (float(rows * per), float(cmps)), nbytes
    if name == "sweep":           # rows windows x Q rows, each its C-steps and objective
        n = rows * Q
        tree = P + (P - half) + 2 * half + (half - 1)   # as the refit's
        step = 5 * P + 5 * tree + 12                    # residuals, five trees, solve
        obj = 5 * P + P + max(2 * half - 1, 0)          # residuals, sel * r2, the tree
        flops = n * (n_steps * step + (obj if objective else 0))
        cmps = n * (n_steps + bool(objective)) * (P * (P - 1) // 2)
        nbytes = itemsize * (rows * P + 2 * P + 4 * n + (n if objective else 0))
        return (float(flops), float(cmps)), nbytes
    if name == "residuals2":      # rows windows x Q fits x P: mul, fma, sub, mul
        n = rows * Q * P
        return 5.0 * n, itemsize * (rows * P + 2 * P + 2 * rows * Q + n)
    if name == "refit":           # rows x Q rows of P weights, one tau row a window
        n = rows * Q
        # a tree: P leaf products (w X or w tau), P - half rounded products,
        # half fused multiply-adds, half - 1 adds; then det, numerators, divisions
        tree = P + (P - half) + 2 * half + (half - 1)
        return float(n * (5 * tree + 12)), itemsize * (n * P + rows * P + 2 * P + 2 * n)
    if name == "residuals2_lag":  # as residuals2, the delay's product in an fma
        n = rows * Q * P
        return 6.0 * n, itemsize * (rows * P + 2 * P + 2 * rows * Q + n)
    n = rows * Q                  # elemental: two mul + two fma a candidate
    return 6.0 * n, itemsize * (rows * P + 4 * Q + 2 * n) + 8 * 2 * Q


def sweep_bound(rows, Q, P, n_steps=4, objective=True, name="sweep", roles=0):
    """(bound ms, bound_by) of one lts_sweep.sweep launch (or of ``name``,
    "final": Q the candidates a window): the larger of its float operations
    at PEAK_FP32_FLOPS, its comparisons at PEAK_COMPARES (two pipes of the
    SM that run side by side) and its bytes at PEAK_HBM_BYTES."""
    (flops, cmps), nbytes = lts_sweep_work(name, rows, Q, P, n_steps=n_steps,
                                           objective=objective, roles=roles)
    ops_ms = max(flops / PEAK_FP32_FLOPS, cmps / PEAK_COMPARES) * 1e3
    mem_ms = nbytes / PEAK_HBM_BYTES * 1e3
    return max(ops_ms, mem_ms), ("operations" if ops_ms >= mem_ms else "bytes")


def bit_diff(got, want) -> int:
    """How many values of ``got`` and ``want`` (one shape) differ in their
    bits, a NaN equal to any NaN."""
    import torch

    got, want = got.cpu(), want.cpu()
    if got.shape != want.shape:
        return max(got.numel(), want.numel(), 1)
    if not got.is_floating_point():
        return int((got != want).sum())
    idt = torch.int16 if got.element_size() == 2 else torch.int32
    return int(((got.view(idt) != want.view(idt)) & ~(torch.isnan(got) & torch.isnan(want)))
               .sum())


def same_sweep(tag, got, want):
    """s and obj of lts_sweep.sweep bit for bit its plain version's (a NaN
    equals a NaN)."""
    for name, g, w in (("s", got[0], want[0]), ("obj", got[1], want[1])):
        if (g is None) != (w is None) or (g is not None and g.shape != w.shape):
            fail(f"lts_sweep sweep {tag}: {name} is {g if g is None else g.shape} against "
                 f"{w if w is None else w.shape}")
        bad = 0 if g is None else bit_diff(g, w)
        if bad:
            err = float((g.float() - w.float()).abs().nan_to_num(float("inf")).max())
            fail(f"lts_sweep sweep {tag}: {bad} of {g.numel()} {name} values "
                 f"differ from sweep_reference (max {err:.3e})")


def check_sweep(tag, tau, X, s, h, n_steps, contract, lag=None, inv_fs=0.0, roles=0):
    """lts_sweep.sweep against sweep_reference on the card, bit for bit;
    returns the kernel's (s, obj)."""
    from narrow_band_least_squares_tpu_torch.ops.kernels import lts_sweep as LS

    got = LS.sweep(tau, X, s, h, n_steps, contract, True, lag, inv_fs, roles)
    same_sweep(tag, got, LS.sweep_reference(tau, X, s, h, n_steps, contract, True, lag,
                                            float(np.float32(inv_fs)), roles))
    return got


def check_funnel(tag, tau, X, s, cand_ok, h, c_steps, k, lag=None, inv_fs=0.0, roles=(0, 0)):
    """The funnel's two sweep launches (one lone C-step and the objective;
    the survivors' c_steps - 1 steps and theirs), each bit for bit its
    plain version; ``roles`` of each launch."""
    import torch
    from narrow_band_least_squares_tpu_torch.ops import lts as LTS

    P = tau.shape[-1]
    s1, obj = check_sweep(f"{tag} funnel first", tau, X, s, h, 1,
                          LTS.refit_contractions(P, "single"), lag, inv_fs, roles[0])
    obj = torch.where(cand_ok, obj, torch.full_like(obj, float("inf")))
    surv = LTS._take(s1, LTS._survivors(obj, k))
    check_sweep(f"{tag} funnel survivors", tau, X, surv, h, c_steps - 1,
                LTS.refit_contractions(P, "single" if c_steps == 2 else "loop"), lag,
                inv_fs, roles[1])


# nbls_lts_sweep's last argument but the stream (csrc/lts_sweep.cu): the
# route by P, as the wrapper launches it, or never the thread route (the
# warp route at every P <= 64, the design before the thread route), to
# compare the two on the same inputs
ROUTE_BY_P, ROUTE_NO_THREAD = 0, 1


def sweep_launch(route, tau, X, s, h, n_steps, contract, objective=True, lag=None,
                 inv_fs=0.0, roles=0, eps=1e-12):
    """One nbls_lts_sweep launch on ``route``, past the wrapper (so counted
    nowhere): (s, obj) as `lts_sweep.sweep` returns them.  Fails unless the
    launcher reports the route asked for: `sweep_route`'s by P, and never
    the thread route under ROUTE_NO_THREAD."""
    import ctypes

    import torch
    from narrow_band_least_squares_tpu_torch.ops.kernels import lts_sweep as LS

    P, Q = tau.shape[-1], s.shape[-2]
    tau, X, s = tau.contiguous(), X.contiguous(), s.contiguous()
    lag = lag.contiguous() if roles else None
    launched = ctypes.c_int(-1)
    s_out = torch.empty_like(s)
    obj = (torch.empty(s.shape[:-1], dtype=tau.dtype, device=tau.device) if objective
           else None)
    err = LS._lib().nbls_lts_sweep(
        LS._DTYPES[tau.dtype], tau.data_ptr(), X.data_ptr(), s.data_ptr(),
        None if lag is None else lag.data_ptr(), float(np.float32(inv_fs)),
        s_out.data_ptr(), None if obj is None else obj.data_ptr(), tau.numel() // P, Q, P,
        int(h), int(n_steps), int(contract), int(bool(objective)), int(roles), eps, route,
        ctypes.byref(launched), torch.cuda.current_stream().cuda_stream)
    if err:
        fail(f"nbls_lts_sweep on route {route} did not launch: CUDA error {err}")
    want = LS.sweep_route(P, tau.dtype)
    if route == ROUTE_NO_THREAD and want == "thread":
        want = "warp"
    if LS.ROUTES[launched.value] != want:
        fail(f"nbls_lts_sweep (route argument {route}, P = {P}, {tau.dtype}) launched its "
             f"{LS.ROUTES[launched.value]} route, not its {want} route")
    return s_out, obj


def sweep_geometry(P, seed, windows=(4, 8), Q=300, coarray_of=True):
    """(tau, X, s, lag) on the card at P equations, X the co-array of n
    elements, n (n - 1) / 2 = P (``coarray_of`` False: a random (P, 2) X):
    plane-wave delays on integer lags at fs = 10, a fifth of the equations
    hit by outliers, and candidate fits with the hard cases: a NaN fit and
    an infinite one (NaN and +inf residuals), a zero fit on a row of equal
    delays (every key tied), -0.0 delays; Q = 300 candidates a window take
    three blocks of the thread route, the last partial."""
    import torch
    from narrow_band_least_squares_tpu_torch.utils.geometry import coarray

    rng = np.random.default_rng(seed)
    nch = int(round((1 + np.sqrt(1 + 8 * P)) / 2))
    theta = np.linspace(0, 2 * np.pi, nch, endpoint=False)
    X = coarray(np.stack([np.cos(theta) * rng.uniform(0.5, 1.5, nch),
                          np.sin(theta) * rng.uniform(0.5, 1.5, nch)]))[0]
    if not coarray_of:
        X = rng.standard_normal((P, 2))
    if X.shape[0] != P:
        fail(f"sweep_geometry: {nch} elements give P = {X.shape[0]}, not {P}")
    tau = (X @ rng.standard_normal(windows + (2, 1)) * 0.5)[..., 0]
    tau = tau + 0.02 * rng.standard_normal(windows + (P,))
    k = max(P // 5, 1)
    tau[..., :k] += rng.standard_normal(windows + (k,))
    lag = np.round(tau * 10).astype(np.float32)
    tau = (lag * np.float32(0.1)).astype(np.float32)
    tau[0, 1], lag[0, 1] = np.float32(0.5), 5.0          # a row of equal delays
    tau[1, 0, :3], lag[1, 0, :3] = -0.0, -0.0
    s = (rng.standard_normal(windows + (Q, 2)) * 0.3).astype(np.float32)
    s[0, 0, 0] = np.nan
    s[0, 0, 1] = [np.inf, 0.0]
    s[0, 1, :3] = 0.0                                    # ties on the equal row
    return tuple(torch.as_tensor(a).cuda() for a in (tau, X.astype(np.float32), s, lag))


def lts_sweep_sizes(label):
    """`lts_sweep.sweep` at every thread-route size (P = 3 to 36: 3 to 9
    elements) bit for bit `sweep_reference` on `sweep_geometry`'s rows:
    four C-steps ("loop" contractions) and one ("single"), each with the
    objective, under four delay-role masks: none; the objective's ranked
    keys alone (its pass counts every ordered pair); the steps' ranked keys
    alone; every role.  The same launches on the warp route
    (ROUTE_NO_THREAD) bit for bit too.  Every launch of the wrapper must
    take the thread route."""
    import torch
    from narrow_band_least_squares_tpu_torch.ops import lts as LTS
    from narrow_band_least_squares_tpu_torch.ops.kernels import lts_sweep as LS

    zero_launches()
    n = 0
    for P in LS.THREAD_SIZES:
        tau, X, s, lag = sweep_geometry(P, SEED + P)
        h = LTS.lts_h(LTS_ALPHA, P)
        for n_steps, site in ((4, "loop"), (1, "single")):
            c = LTS.refit_contractions(P, site)
            for roles in (0, 0b000100, 0b000001, 0b111111):
                tag = f"P={P} {n_steps} steps roles {roles:06b}"
                want = LS.sweep_reference(tau, X, s, h, n_steps, c, True, lag, 0.1, roles)
                same_sweep(f"{tag} (thread route)",
                           LS.sweep(tau, X, s, h, n_steps, c, True, lag, 0.1, roles), want)
                same_sweep(f"{tag} (warp route)", sweep_launch(
                    ROUTE_NO_THREAD, tau, X, s, h, n_steps, c, True, lag, 0.1, roles), want)
                n += 1
    torch.cuda.synchronize()
    launches = lts_sweep_launches()
    if (launches["sweep"], launches["sweep_thread"]) != (n, n):
        fail(f"lts_sweep sizes: {n} sweep launches must all take the thread route; "
             f"{launches}")
    log(f"[{label}] lts_sweep sweep at P = {list(LS.THREAD_SIZES)} ({tuple(tau.shape)} x "
        f"{s.shape[-2]} candidates, NaN, +inf, tied and -0.0 cases): bit for bit "
        f"sweep_reference on the thread route ({n} launches, all counted in "
        f"launches_sweep_thread) and on the warp route, 4 and 1 C-steps, roles "
        f"000000, 000100 (the objective's full count), 000001 (the steps'), 111111")


def lts_sweep_routes(label, st):
    """The sweep on its warp route (ROUTE_NO_THREAD, the earlier design) and
    its route by P on the same inputs, in turns (warp, by P, by P, warp),
    device ms a launch (`device_ms`, 20 launches), the two routes' outputs
    bit for bit each other's: at the canonical and dense50 LTS shapes (P =
    28, 378 candidates) with n_steps 0 (the objective's pass alone), 1 and
    4 (the exhaustive sweep) beside `sweep_bound`; then at every
    thread-route size (`sweep_route_sizes`).  Returns the canonical
    four-step times {route: [ms, ms]}."""
    import functools

    import torch
    from narrow_band_least_squares_tpu_torch.models import NarrowBandPipeline
    from narrow_band_least_squares_tpu_torch.ops import lts as LTS
    from narrow_band_least_squares_tpu_torch.ops.kernels import lts_sweep as LS
    from narrow_band_least_squares_tpu_torch.utils import get_rij, make_plan

    rij = get_rij(st.latitudes, st.longitudes, st.nchans)
    _, freqlist, winlens = canonical_inputs()
    plans = {"canonical": make_plan(freqlist, "log", winlens, WINOVER, st.npts, st.fs),
             "dense50": dense50_plan(st)}
    canonical = None
    for name, plan in plans.items():
        pipe = NarrowBandPipeline(plan, rij, alpha=LTS_ALPHA, device="cuda")
        g = pipe._geometry
        tau = pipe._delays(pipe._filter(pipe._to_device(st.data)))[0]
        s = LS.elemental(tau, g["cand"], g["Ainv"])
        rows, Q, P = tau[..., 0].numel(), s.shape[-2], tau.shape[-1]
        per = {}
        for n_steps in (0, 1, 4):
            c = LTS.refit_contractions(P, "single" if n_steps == 1 else "loop")
            runs = {r: functools.partial(sweep_launch, r, tau, g["X"], s, pipe.h, n_steps, c)
                    for r in (ROUTE_NO_THREAD, ROUTE_BY_P)}
            same_sweep(f"{name} {n_steps} steps: thread route against warp route",
                       runs[ROUTE_BY_P](), runs[ROUTE_NO_THREAD]())
            ms = {"warp": [], "thread": []}
            for route in ("warp", "thread", "thread", "warp"):
                ms[route].append(device_ms(
                    runs[ROUTE_BY_P if route == "thread" else ROUTE_NO_THREAD], reps=20))
            bound, by = sweep_bound(rows, Q, P, n_steps)
            per[n_steps] = ms
            log(f"[{label}] lts_sweep sweep routes at {name} ({rows} windows x {Q} candidates "
                f"x {P}), {n_steps} C-steps and the objective: warp route "
                f"{ms['warp'][0]:.4f} / {ms['warp'][1]:.4f} ms, thread route "
                f"{ms['thread'][0]:.4f} / {ms['thread'][1]:.4f} ms a launch (in turns warp, "
                f"thread, thread, warp; 20 launches each); bound {bound:.4f} ms by {by}; "
                f"the two routes bit for bit")
        for route in ("warp", "thread"):
            t = {k: sum(v[route]) / 2 for k, v in per.items()}
            log(f"[{label}] lts_sweep sweep {route} route at {name}: the objective's pass "
                f"alone {t[0]:.4f} ms, a C-step {t[1] - t[0]:.4f} ms (1 step - 0), "
                f"{(t[4] - t[1]) / 3:.4f} ms ((4 steps - 1) / 3)")
        if name == "canonical":
            canonical = per[4]
        del pipe
        torch.cuda.empty_cache()
    sweep_route_sizes(label)
    return canonical


def sweep_cells(P, c_steps=4, capped=5):
    """The sweep launches of an LTS solve at P equations (Q = P (P - 1) / 2
    candidates), as (cell, candidates, C-steps): the exhaustive sweep, the
    funnel's two launches where it runs ('auto': k = max(16, ceil(Q / 24))
    survivors, models/narrowband.py) and a capped sweep (max_lts_candidates
    = ``capped``) where it caps."""
    Q = P * (P - 1) // 2
    k = max(16, -(-Q // 24))
    cells = [("exhaustive", Q, c_steps)]
    if k < Q:
        cells += [("funnel first", Q, 1), ("funnel survivors", k, c_steps - 1)]
    if capped < Q:
        cells.append(("capped", capped, c_steps))
    return cells


def sweep_route_sizes(label, windows=(8, 79)):
    """The warp route (ROUTE_NO_THREAD) and the route by P in turns (warp,
    by P, by P, warp) at every thread-route size, on `sweep_geometry`'s
    rows with the canonical count of windows, in each of `sweep_cells`:
    device ms a launch (`device_ms`, 20 launches), the two routes bit for
    bit each other's.  Returns {P: {cell: (warp ms, by-P ms)}}, each the
    mean of its two turns."""
    import functools

    from narrow_band_least_squares_tpu_torch.ops import lts as LTS
    from narrow_band_least_squares_tpu_torch.ops.kernels import lts_sweep as LS

    out = {}
    for P in LS.THREAD_SIZES:
        h = LTS.lts_h(LTS_ALPHA, P)
        out[P] = {}
        for cell, Q, n_steps in sweep_cells(P):
            tau, X, s, _ = sweep_geometry(P, SEED + P, windows=windows, Q=Q)
            c = LTS.refit_contractions(P, "single" if n_steps == 1 else "loop")
            runs = {r: functools.partial(sweep_launch, r, tau, X, s, h, n_steps, c)
                    for r in (ROUTE_NO_THREAD, ROUTE_BY_P)}
            same_sweep(f"P={P} {cell}: route by P against warp route",
                       runs[ROUTE_BY_P](), runs[ROUTE_NO_THREAD]())
            ms = {ROUTE_NO_THREAD: [], ROUTE_BY_P: []}
            for r in (ROUTE_NO_THREAD, ROUTE_BY_P, ROUTE_BY_P, ROUTE_NO_THREAD):
                ms[r].append(device_ms(runs[r], reps=20))
            warp, by_p = (sum(ms[r]) / 2 for r in (ROUTE_NO_THREAD, ROUTE_BY_P))
            out[P][cell] = (warp, by_p)
            log(f"[{label}] lts_sweep sweep at P = {P}, {cell} ({windows[0] * windows[1]} "
                f"windows x {Q} candidates, {n_steps} C-steps and the objective): warp route "
                f"{ms[ROUTE_NO_THREAD][0]:.4f} / {ms[ROUTE_NO_THREAD][1]:.4f} ms, "
                f"{LS.sweep_route(P, tau.dtype)} route (by P) {ms[ROUTE_BY_P][0]:.4f} / "
                f"{ms[ROUTE_BY_P][1]:.4f} ms a launch (in turns; 20 launches each), "
                f"by P / warp {by_p / warp:.3f}; the two routes bit for bit")
        paths = {"exhaustive": ("exhaustive",), "auto": ("funnel first", "funnel survivors")}
        sums = {name: [sum(out[P][c][i] for c in cells) for i in (0, 1)]
                for name, cells in paths.items() if all(c in out[P] for c in cells)}
        log(f"[{label}] lts_sweep sweep at P = {P}, per solve: " + "; ".join(
            f"{name} warp {w:.4f} ms, by P {b:.4f} ms" for name, (w, b) in sums.items()))
    return out


# Every output of lts_sweep.final, in the order of its record
FINAL_KEYS = ("objective", "s", "retained", "sig_tau", "vel_uncert", "baz_uncert")
# The sizes `final` is held at beyond the canonical P = 28: every thread-route
# size, two more co-arrays one warp a row takes in two halves (10 and 11
# elements) and the longest row it takes
FINAL_SIZES = (3, 6, 10, 15, 21, 28, 36, 45, 55, 64)


def check_final(tag, tau, X, obj, s, h, lag=None, inv_fs=0.0, roles=0):
    """lts_sweep.final against final_reference on the card, every output
    bit for bit (`FINAL_KEYS`), at the final refit's contractions; returns
    the kernel's outputs."""
    from narrow_band_least_squares_tpu_torch.ops import lts as LTS
    from narrow_band_least_squares_tpu_torch.ops.kernels import lts_sweep as LS

    P = tau.shape[-1]
    dof, c = max(h - 2, 1), LTS.refit_contractions(P, "final")
    got = LS.final(tau, X, obj, s, h, dof, c, lag, inv_fs, roles)
    want = LS.final_reference(tau, X, obj, s, h, dof, c, lag, float(np.float32(inv_fs)), roles)
    for k in FINAL_KEYS:
        bad = bit_diff(got[k], want[k])
        if bad:
            fail(f"lts_sweep final {tag}: {bad} of {want[k].numel()} {k} values differ from "
                 f"final_reference")
    return got


def final_adversarial(obj, s):
    """(obj, s) with the hard rows of the first minimum: window 0 all +inf
    (index 0 wins), window 1's minimum tied at three candidates (the first
    wins), windows 2 and 3 a NaN and an infinite best fit (NaN and +inf
    residuals: every key +inf, ranks by index)."""
    import torch

    K = obj.shape[-1]
    obj, s = obj.clone().reshape(-1, K), s.clone().reshape(-1, K, 2)
    obj[0] = float("inf")
    obj[1, [K - 1, K // 2, K - 2]] = obj[1].min()
    for w, bad in ((2, (float("nan"), 0.3)), (3, (float("inf"), 0.0))):
        obj[w, K // 3] = -1.0
        s[w, K // 3] = torch.tensor(bad, dtype=s.dtype, device=s.device)
    return obj, s


def lts_final_check(label, st):
    """`lts_sweep.final` bit for bit `final_reference` on the card in every
    output (`check_final`), in each cell that reaches it: the canonical
    exhaustive solve's candidates (632 windows x 378, after the cand_ok
    mask), 'auto' (the funnel's 16 survivors), a chunked sweep's block
    minima (blocks of 100, padded as `lts_solve` pads them: 4 a window),
    adversarial objectives (`final_adversarial`), bfloat16, every size of
    `FINAL_SIZES` on `sweep_geometry`'s rows (NaN, +inf, tied and -0.0
    residuals) under each delay-role mask, and a degenerate co-array (X1 =
    0: every refit singular, s = 0, |s|^2 at its floor); `lts_one_band`
    and `lts_capped_case` hold the one-band and capped cells.  Then times
    final at canonical and dense50 (`device_ms`, 20 launches) beside its
    bound (`sweep_bound`), its plain version on the card and the separate
    passes it replaced (`ops.lts._final_passes`, one call's device ms and
    kernels); returns its kernels-line record."""
    import torch
    from narrow_band_least_squares_tpu_torch.models import NarrowBandPipeline
    from narrow_band_least_squares_tpu_torch.ops import lts as LTS
    from narrow_band_least_squares_tpu_torch.ops.kernels import lts_sweep as LS
    from narrow_band_least_squares_tpu_torch.utils import get_rij, make_plan

    rij = get_rij(st.latitudes, st.longitudes, st.nchans)
    _, freqlist, winlens = canonical_inputs()
    plans = {"canonical": make_plan(freqlist, "log", winlens, WINOVER, st.npts, st.fs),
             "dense50": dense50_plan(st)}
    inputs = {}
    for name, plan in plans.items():
        pipe = NarrowBandPipeline(plan, rij, alpha=LTS_ALPHA, device="cuda")
        g = pipe._geometry
        tau = pipe._delays(pipe._filter(pipe._to_device(st.data)))[0]
        inputs[name] = (pipe, tau) + LTS._candidate_sweep(
            tau, g["X"], g["cand"], g["Ainv"], g["cand_ok"], pipe.h, pipe.c_steps)
    pipe, tau, obj, s = inputs["canonical"]
    g, h, steps = pipe._geometry, pipe.h, pipe.c_steps
    X, cand, Ainv, ok = g["X"], g["cand"], g["Ainv"], g["cand_ok"]
    Q = cand.shape[0]
    check_final("canonical exhaustive", tau, X, obj, s, h)
    check_final("canonical 'auto'", tau, X, *LTS._candidate_sweep(
        tau, X, cand, Ainv, ok, h, steps, max(16, -(-Q // 24))), h)
    chunk = 100
    pad = -(-Q // chunk) * chunk - Q
    cc = torch.cat([cand.long(), cand.new_zeros((pad, 2)).long()])
    aa, oo = torch.cat([Ainv, Ainv.new_zeros((pad, 2, 2))]), torch.cat([ok, ok.new_zeros(pad)])
    blocks = [LTS._best(*LTS._candidate_sweep(tau, X, cc[c:c + chunk], aa[c:c + chunk],
                                              oo[c:c + chunk], h, steps))
              for c in range(0, Q + pad, chunk)]
    check_final(f"canonical chunked ({len(blocks)} blocks of {chunk})", tau, X,
                torch.stack([b[0] for b in blocks], -1), torch.stack([b[1] for b in blocks], -2),
                h)
    adv_obj, adv_s = final_adversarial(obj, s)
    check_final("canonical adversarial objectives", tau.reshape(-1, tau.shape[-1]), X, adv_obj,
                adv_s, h)
    bf = lambda t: t.to(torch.bfloat16)
    check_final("bfloat16", bf(tau[:2]), bf(X), *LTS._candidate_sweep(
        bf(tau[:2]), bf(X), cand, bf(Ainv), ok, h, steps), h)
    for P in FINAL_SIZES:
        tau_p, X_p, s_p, lag_p = sweep_geometry(P, SEED + P, coarray_of=P != 64)
        h_p = LTS.lts_h(LTS_ALPHA, P)
        s4, o4 = LS.sweep(tau_p, X_p, s_p, h_p, 4, LTS.refit_contractions(P, "loop"))
        o4, s4 = final_adversarial(o4, s4)
        rows = tau_p.reshape(-1, P)
        for roles in (0, 0b01, 0b10, 0b11):
            check_final(f"P={P} roles {roles:02b}", rows, X_p, o4, s4, h_p,
                        lag_p.reshape(-1, P), 0.1, roles)
    Xd = X.clone()
    Xd[:, 1] = 0.0
    sd, od = LS.sweep(tau, Xd, s, h, steps, LTS.refit_contractions(28, "loop"))
    got = check_final("degenerate co-array (X1 = 0)", tau, Xd, od, sd, h)
    if got["s"].any() or not torch.isfinite(got["vel_uncert"]).all():
        fail("lts_sweep final on a degenerate co-array: s is not 0 everywhere or "
             "vel_uncert not finite")
    torch.cuda.synchronize()
    log(f"[{label}] lts_sweep final bit for bit final_reference ({', '.join(FINAL_KEYS)}): "
        f"canonical {tuple(tau.shape)} exhaustive (K = {Q}), 'auto' (K = 16), chunked "
        f"({len(blocks)} blocks of {chunk}), adversarial objectives, bfloat16, P = "
        f"{list(FINAL_SIZES)} (roles 00, 01, 10, 11), a degenerate co-array (s = 0)")

    rec = None
    for name, (pipe, tau, obj, s) in inputs.items():
        X, h = pipe._geometry["X"], pipe.h
        rows, K, P = tau[..., 0].numel(), obj.shape[-1], tau.shape[-1]
        dof, c = max(h - 2, 1), LTS.refit_contractions(P, "final")
        kern = lambda: LS.final(tau, X, obj, s, h, dof, c)
        ms = device_ms(kern, reps=20)
        pms = device_ms(lambda: LS.final_reference(tau, X, obj, s, h, dof, c), reps=3)
        passes = lambda: LTS._final_passes(tau, X, obj, s, h, dof)
        passes_ms = device_ms(passes, reps=20)
        busy, top = profile_once(passes)
        kbusy, _ = profile_once(kern)
        bound, by = sweep_bound(rows, K, P, name="final")
        (flops, cmps), nbytes = lts_sweep_work("final", rows, K, P)
        log(f"[{label}] lts_sweep final at {name} ({rows} windows x {K} candidates x {P}): "
            f"{ms:.4f} ms a launch ({kbusy:.4f} ms profiled), plain version on the card "
            f"{pms:.4f} ms, the separate passes it replaced {passes_ms:.4f} ms "
            f"({busy:.4f} ms in {sum(r[2] for r in top)} kernels, one profiled call); bound "
            f"{bound:.5f} ms by {by} ({nbytes / 1e6:.3f} MB, {flops / 1e6:.2f} MFLOP, "
            f"{cmps / 1e6:.3f} M comparisons)")
        if name == "canonical":
            rec = {"name": "lts_sweep.final", "route": "cuda", "per": "launch",
                   "source": LTS_SWEEP_SOURCE, "replaces": LTS_SWEEP_REPLACES["final"],
                   "launches": 0, "max_abs_err": 0.0, "ms": ms, "plain_ms": pms,
                   "bound_ms": bound, "bound_by": by, "library_ms": None,
                   "passes_ms": passes_ms}
        else:
            rec.update(dense50_ms=ms, dense50_bound_ms=bound, dense50_passes_ms=passes_ms)
    del inputs
    torch.cuda.empty_cache()
    return rec


def lts_kernel_check(label, st, freqlist, winlens):
    """Each lts_sweep entry point against its plain version on the card,
    bit for bit: on the canonical LTS sweep's shapes (632 windows x 378
    candidates x 28 equations: the elemental solves, the residuals of those
    fits, the refit of their h smallest with every first level contracted
    and with b0 and b1 not, and the one-fit-a-row layout of the final refit
    and its residuals), in bfloat16 on a slice, and at P = 120 (16
    elements, 1,024 candidates).  `sweep` (the C-steps and the objective in
    one launch) on the canonical exhaustive sweep (four "loop" C-steps),
    its funnel ('auto': a lone "single" step, then the survivors'), in
    bfloat16, and at P = 120 on the block route in both chunks of 4096 of
    the 7,140 candidates.  Times each at the shapes the main path gives it
    (`sweep` and `elemental` at the canonical sweep's, `residuals2` and
    `refit` at the final subset's, one fit a window; those two also at the
    sweep's shapes, where they ran before `sweep`); returns the
    kernels-line records (launches filled in by the API run)."""
    import torch
    from narrow_band_least_squares_tpu_torch.io import synthetic_plane_wave
    from narrow_band_least_squares_tpu_torch.models import NarrowBandPipeline
    from narrow_band_least_squares_tpu_torch.ops import lts as LTS
    from narrow_band_least_squares_tpu_torch.ops.kernels import lts_sweep as LS
    from narrow_band_least_squares_tpu_torch.utils import (
        get_freqlist, get_rij, get_winlenlist, make_plan,
    )

    def same(name, got, want):
        if not torch.equal(got, want):
            bad = int((got != want).sum())
            err = float((got.float() - want.float()).abs().max())
            fail(f"lts_sweep {name}: {bad} of {got.numel()} values differ from the "
                 f"plain version (max {err:.3e})")

    def check(tag, tau, X, cand, Ainv, h, contracts):
        s = LS.elemental(tau, cand, Ainv)
        same(f"elemental {tag}", s, LS.elemental_reference(tau, cand, Ainv))
        r2 = LS.residuals2(tau, X, s)
        same(f"residuals2 {tag}", r2, LS.residuals2_reference(tau, X, s))
        w = (LTS._rank_along_last(r2) < h).to(tau.dtype)
        for c in contracts:
            got = LS.refit(tau[..., None, :], X, w, contract=c)
            same(f"refit {tag} contract {c:05b}", got,
                 LS.refit_reference(tau[..., None, :], X, w, contract=c))
        w1 = w[..., 0, :]             # one fit a row, as the final refit
        same(f"refit {tag} one row a window", LS.refit(tau, X, w1),
             LS.refit_reference(tau, X, w1))
        same(f"residuals2 {tag} one fit a row", LS.residuals2(tau, X, s[..., :1, :]),
             LS.residuals2_reference(tau, X, s[..., :1, :]))
        return s, r2, w

    plan = make_plan(freqlist, "log", winlens, WINOVER, st.npts, st.fs)
    pipe = NarrowBandPipeline(plan, get_rij(st.latitudes, st.longitudes, st.nchans),
                              alpha=LTS_ALPHA, device="cuda")
    g = pipe._geometry
    tau = pipe._delays(pipe._filter(pipe._to_device(st.data)))[0]
    X, cand, Ainv = g["X"], g["cand"], g["Ainv"]
    P, Q, h = tau.shape[-1], cand.shape[0], pipe.h
    contracts = (LS.ALL_CONTRACTED, LTS.refit_contractions(28, "final"))
    s, r2, w = check("canonical", tau, X, cand, Ainv, h, contracts)
    loop = LTS.refit_contractions(P, "loop")
    check_sweep("canonical exhaustive", tau, X, s, h, pipe.c_steps, loop)
    k_auto = max(16, -(-Q // 24))       # lts_funnel_k='auto'
    check_funnel("canonical 'auto'", tau, X, s, g["cand_ok"], h, pipe.c_steps, k_auto)
    torch.cuda.synchronize()
    bf = lambda t: t.to(torch.bfloat16)
    bs, _, _ = check("bfloat16", bf(tau[:2]), bf(X), cand, bf(Ainv), h, contracts)
    check_sweep("bfloat16", bf(tau[:2]), bf(X), bs, h, pipe.c_steps, loop)

    big = synthetic_plane_wave(**LTS_LARGE_STREAM)
    fl, nb, _ = get_freqlist(0.3, 1.2, "log", 2)
    bplan = make_plan(fl, "log", get_winlenlist("constant", nb, 30, 0, 0), 0.5,
                      big.npts, big.fs)
    brij = get_rij(big.latitudes, big.longitudes, big.nchans)
    bpipe = NarrowBandPipeline(bplan, brij, alpha=LTS_ALPHA, max_lts_candidates=1024,
                               device="cuda")
    bg = bpipe._geometry
    btau = bpipe._delays(bpipe._filter(bpipe._to_device(big.data)))[0]
    check("P=120", btau, bg["X"], bg["cand"], bg["Ainv"], bpipe.h,
          (LS.ALL_CONTRACTED, LTS.refit_contractions(120, "loop")))
    full = NarrowBandPipeline(bplan, brij, alpha=LTS_ALPHA, device="cuda")
    fg, chunk = full._geometry, full.lts_candidate_chunk
    nfull = fg["cand"].shape[0]
    if (nfull, chunk) != (7140, 4096):
        fail(f"lts_sweep sweep P=120: {nfull} candidates in chunks of {chunk}")
    for c0 in range(0, nfull, chunk):      # the last chunk padded as lts_solve pads it
        cc = torch.cat([fg["cand"][c0:c0 + chunk].long(),
                        fg["cand"].new_zeros((max(0, c0 + chunk - nfull), 2)).long()])
        aa = torch.cat([fg["Ainv"][c0:c0 + chunk],
                        fg["Ainv"].new_zeros((max(0, c0 + chunk - nfull), 2, 2))])
        check_sweep(f"P=120 chunk {c0 // chunk}", btau, fg["X"],
                    LS.elemental(btau, cc, aa), full.h, full.c_steps,
                    LTS.refit_contractions(120, "loop"))
    torch.cuda.synchronize()
    log(f"[{label}] lts_sweep: elemental, residuals2 and refit bit for bit their plain "
        f"versions on the card: canonical {tuple(tau.shape)} x {Q} candidates, "
        f"bfloat16, P=120 {tuple(btau.shape)} x {bg['cand'].shape[0]} candidates; "
        f"refit contract masks {[f'{c:05b}' for c in contracts]}; sweep bit for bit "
        f"sweep_reference: canonical exhaustive ({pipe.c_steps} steps) and canonical "
        f"'auto' (k = {k_auto}: 1 step, then {pipe.c_steps - 1} on the survivors) on the "
        f"thread route, bfloat16 on the warp route, P=120 {tuple(btau.shape)} in "
        f"{-(-nfull // chunk)} chunks of {chunk} on the block route")

    rows = tau[..., 0].numel()
    s1, w1 = s[..., :1, :], w[..., :1, :]      # the final subset: one fit a window
    calls = {
        "sweep": ((lambda: LS.sweep(tau, X, s, h, pipe.c_steps, loop)),
                  (lambda: LS.sweep_reference(tau, X, s, h, pipe.c_steps, loop)), Q),
        "elemental": (lambda: LS.elemental(tau, cand, Ainv),
                      lambda: LS.elemental_reference(tau, cand, Ainv), Q),
        "residuals2": (lambda: LS.residuals2(tau, X, s1),
                       lambda: LS.residuals2_reference(tau, X, s1), 1),
        "refit": (lambda: LS.refit(tau[..., None, :], X, w1),
                  lambda: LS.refit_reference(tau[..., None, :], X, w1), 1),
    }
    recs = []
    for name, (kern, plain, q) in calls.items():
        ms = device_ms(kern, reps=20)
        pms = device_ms(plain, reps=3)
        if name == "sweep":
            bound, by = sweep_bound(rows, q, P, pipe.c_steps)
            (flops, cmps), nbytes = lts_sweep_work(name, rows, q, P, n_steps=pipe.c_steps)
            work = (f"{flops / 1e6:.1f} MFLOP, {cmps / 1e6:.1f} M comparisons, "
                    f"{nbytes / 1e6:.2f} MB")
        else:
            flops, nbytes = lts_sweep_work(name, rows, q, P)
            ops_ms, mem_ms = flops / PEAK_FP32_FLOPS * 1e3, nbytes / PEAK_HBM_BYTES * 1e3
            bound, by = max(ops_ms, mem_ms), ("operations" if ops_ms >= mem_ms else "bytes")
            work = f"{flops / 1e6:.1f} MFLOP, {nbytes / 1e6:.2f} MB"
        log(f"[{label}] lts_sweep {name} at the main path's shapes ({rows} windows x {q} "
            f"{'candidates' if q > 1 else 'fit'} x {P}): kernel {ms:.4f} ms a launch, plain "
            f"version on the card {pms:.4f} ms, bound {bound:.4f} ms by {by} ({work})")
        recs.append({"name": f"lts_sweep.{name}", "route": "cuda", "per": "launch",
                     "source": LTS_SWEEP_SOURCE, "replaces": LTS_SWEEP_REPLACES[name],
                     "launches": 0, "max_abs_err": 0.0, "ms": ms, "plain_ms": pms,
                     "bound_ms": bound, "bound_by": by, "library_ms": None})
    for name, kern in (("residuals2", lambda: LS.residuals2(tau, X, s)),
                       ("refit", lambda: LS.refit(tau[..., None, :], X, w))):
        flops, nbytes = lts_sweep_work(name, rows, Q, P)
        log(f"[{label}] lts_sweep {name} at the candidate sweep's shapes ({rows} x {Q} x "
            f"{P}, where it ran before sweep): {device_ms(kern, reps=20):.4f} ms a launch, "
            f"bound {max(flops / PEAK_FP32_FLOPS, nbytes / PEAK_HBM_BYTES) * 1e3:.4f} ms")
    return recs


def lts_capped_case(label):
    """The capped-candidate stream (LTS_CAPPED_STREAM, max_lts_candidates =
    5) on the card ('mxu' at 'highest') and the CPU: flags equal on every
    valid window whose delays are bit-identical (at least LTS_SAME_MIN of
    them), and lts_solve on the CPU's delays on the card equal to the CPU's,
    objective, s and retained, bit for bit; lts_sweep.sweep there (Q = 5: a
    block's last three warps idle) bit for bit its plain version."""
    import torch
    from narrow_band_least_squares_tpu_torch.io import synthetic_plane_wave
    from narrow_band_least_squares_tpu_torch.models import NarrowBandPipeline
    from narrow_band_least_squares_tpu_torch.ops import lts as LTS
    from narrow_band_least_squares_tpu_torch.ops.kernels import lts_sweep as LS
    from narrow_band_least_squares_tpu_torch.utils import (
        get_freqlist, get_rij, get_winlenlist, make_plan,
    )

    st = synthetic_plane_wave(**LTS_CAPPED_STREAM)
    fl, nb, _ = get_freqlist(0.2, 1.6, "log", 4)
    plan = make_plan(fl, "log", get_winlenlist("adaptive", nb, 30, 40, 20), 0.5,
                     st.npts, st.fs)
    rij = get_rij(st.latitudes, st.longitudes, st.nchans)
    runs = {}
    for dev in ("cuda", "cpu"):
        pipe = NarrowBandPipeline(plan, rij, alpha=LTS_ALPHA, max_lts_candidates=5,
                                  matmul_precision="highest", device=dev)
        with LtsRecorder() as rec:
            out = pipe.run_raw(st.data)
        runs[dev] = (pipe, {k: v.cpu() for k, v in out.items()}, rec.taus[0])
    pipe, gpu, tau_g = runs["cuda"]
    cpipe, cpu, tau_c = runs["cpu"]
    wm = pipe.state_dict()["win_mask"].cpu().numpy()
    same = (tau_g == tau_c).all(-1) & wm
    if same.sum() < LTS_SAME_MIN * wm.sum():
        fail(f"lts capped: delays differ card against CPU on {int(wm.sum() - same.sum())} "
             f"of {int(wm.sum())} valid windows")
    differ = (gpu["flags"] != cpu["flags"]).any(-1).numpy() & same
    if differ.any():
        fail(f"lts capped: the card's flags differ from the CPU's on windows with "
             f"bit-identical delays {np.argwhere(differ).tolist()}")
    g, cg = pipe._geometry, cpipe._geometry
    args = lambda geo: (geo["X"], geo["cand"], geo["Ainv"], geo["cand_ok"], pipe.h,
                        pipe.c_steps)
    on_card = LTS.lts_solve(torch.as_tensor(tau_c).cuda(), *args(g))
    on_cpu = LTS.lts_solve(torch.as_tensor(tau_c), *args(cg))
    for k in ("objective", "s", "retained"):
        if not torch.equal(on_card[k].cpu(), on_cpu[k]):
            fail(f"lts capped: lts_solve's {k} on the card differs from the CPU's")
    tc = torch.as_tensor(tau_c).cuda()
    check_sweep("capped (Q = 5)", tc, g["X"], LS.elemental(tc, g["cand"], g["Ainv"]),
                pipe.h, pipe.c_steps, LTS.refit_contractions(tc.shape[-1], "loop"))
    obj = on_cpu["objective"].numpy()
    log(f"[{label}] lts capped (max_lts_candidates=5): flags card = CPU on "
        f"{int(same.sum())} of {int(wm.sum())} valid windows (those with bit-identical "
        f"delays); lts_solve objective, s and "
        f"retained bit for bit the CPU's; sweep bit for bit sweep_reference at Q = 5; "
        f"window (band 1, window 4) objective "
        f"{float(obj[1, 4]):.4f}, vel {float(cpu['vel'][1, 4]):.4f}")


def lts_one_band(label, st):
    """One-band ltsva, the vendored entry point, whose JAX program fuses the
    delays into the sweep (ops/lts.py::delay_contracted): the canonical
    stream with its incoherent element band-passed to FMIN-FMAX, card
    against CPU.  The run is driven with the counts at 0 and must launch
    one sweep (its objective's delay roles), one elemental and one final
    (the final subset's ranks and sigma2 take the lags: roles 11); the
    stdicts are equal on every window whose delays are bit-identical (at
    least LTS_SAME_MIN of them) and lts_solve on the CPU's delays and lags
    is on the card the CPU's bit for bit (objective, s, retained; the CPU's
    float32 sqrt, not always correctly rounded, may move sigma_tau's last
    bit).  residuals2_lag is held bit for bit against its
    plain version on the card at P = 15, 28 (this run's shapes) and 120, and
    timed at the final subset's shapes (where it ran before `final`); sweep
    with the exhaustive objective's roles and the funnel's (a lone step's,
    the survivors') and final with the final subset's bit for bit their
    plain versions; the one-band solve is timed with the lags and without
    them (CUDA events).  Returns the kernels-line record of
    lts_sweep.residuals2_lag (its launches filled in by
    `lts_one_band_large`)."""
    import torch
    from narrow_band_least_squares_tpu_torch import api
    from narrow_band_least_squares_tpu_torch.ops import lts as LTS
    from narrow_band_least_squares_tpu_torch.ops.kernels import lts_sweep as LS
    from narrow_band_least_squares_tpu_torch.utils import get_rij, make_plan
    from narrow_band_least_squares_tpu_torch.utils.geometry import coarray

    stf, _, _ = api.filter_data(st, "cheby1", FMIN, FMAX, 2, 0.01, device="cpu")
    args = (stf.latitudes, stf.longitudes, WINLEN, WINOVER, LTS_ALPHA)
    runs = {}
    for dev in ("cuda", "cpu"):
        first_call()
        with LtsRecorder() as rec:
            zero_launches()
            out = api.ltsva(stf, *args, device=dev)
            if dev == "cuda":
                torch.cuda.synchronize()
            launches = lts_sweep_launches()
        if len(rec.taus) != 1 or rec.lags[0] is None:
            fail(f"one-band ltsva on {dev}: {len(rec.taus)} solves, lags passed: "
                 f"{[lag is not None for lag in rec.lags]}")
        runs[dev] = (out, rec.taus[0], rec.lags[0], launches)
    (gpu, tau_g, lag_g, sweep), (cpu, tau_c, lag_c, sweep_c) = runs["cuda"], runs["cpu"]
    want = {"sweep": 1, "sweep_thread": 1, "residuals2": 0, "refit": 0, "elemental": 1,
            "residuals2_lag": 0, "final": 1}
    if sweep != want or any(sweep_c.values()):
        fail(f"one-band ltsva: lts_sweep launches {sweep} on the card, {sweep_c} on "
             f"the CPU ({want} on the card, none on the CPU)")
    n = len(gpu[0])
    keys_g = [k for k in gpu[4] if k != "size"]
    keys_c = [k for k in cpu[4] if k != "size"]
    if keys_g != keys_c or len(keys_g) != n:
        fail("one-band ltsva: the card's stdict keys differ from the CPU's")
    same = (tau_g == tau_c).all(-1)[0, :n]
    if same.sum() < LTS_SAME_MIN * n:
        fail(f"one-band ltsva: delays differ card against CPU on {int(n - same.sum())} "
             f"of {n} windows")
    differ = [w for w in np.flatnonzero(same)
              if not np.array_equal(np.asarray(gpu[4][keys_g[w]]),
                                    np.asarray(cpu[4][keys_c[w]]))]
    if differ:
        fail(f"one-band ltsva: the card's stdict differs from the CPU's on windows "
             f"with bit-identical delays {differ}")
    rij = get_rij(stf.latitudes, stf.longitudes, stf.nchans)
    plan = make_plan([0.0, stf.fs / 2], "linear", [WINLEN], WINOVER, stf.npts, stf.fs)
    pipe = api._get_pipeline(plan, rij, alpha=LTS_ALPHA, apply_filter=False, device="cuda")
    cpipe = api._get_pipeline(plan, rij, alpha=LTS_ALPHA, apply_filter=False, device="cpu")
    P, Q = tau_g.shape[-1], pipe._geometry["cand"].shape[0]
    sites = pipe._delay_sites
    if sites != LTS.delay_contracted(P, "exhaustive"):
        fail(f"one-band ltsva: the pipeline's delay sites {sorted(sites)}")

    def solve(geo, dev):
        return LTS.lts_solve(torch.as_tensor(tau_c).to(dev), *(geo[k] for k in (
            "X", "cand", "Ainv", "cand_ok")), pipe.h, pipe.c_steps,
            lag=torch.as_tensor(lag_c).to(dev), inv_fs=1.0 / stf.fs, delay_sites=sites)

    on_card, on_cpu = solve(pipe._geometry, "cuda"), solve(cpipe._geometry, "cpu")
    for k in ("objective", "s", "retained"):
        if not torch.equal(on_card[k].cpu(), on_cpu[k]):
            fail(f"one-band ltsva: lts_solve's {k} on the card differs from the CPU's")

    def same_lag(tag, lag, X, s_):
        got = LS.residuals2_lag(lag, 1.0 / stf.fs, X, s_)
        want = LS.residuals2_lag_reference(lag, float(np.float32(1.0 / stf.fs)), X, s_)
        if not torch.equal(got, want):
            fail(f"lts_sweep residuals2_lag {tag}: {int((got != want).sum())} of "
                 f"{got.numel()} values differ from the plain version")

    g = pipe._geometry
    tau, _, md = pipe._delays(pipe._filter(pipe._to_device(stf.data)))
    lag = torch.round(tau.double() * stf.fs).float()
    s = LS.elemental(tau, g["cand"], g["Ainv"])
    same_lag(f"P={P}", lag, g["X"], s)
    rng = np.random.default_rng(SEED)
    for nch in (6, 16):
        theta = np.linspace(0, 2 * np.pi, nch, endpoint=False)
        Xn = torch.as_tensor(coarray(np.stack([np.cos(theta), np.sin(theta)]))[0],
                             dtype=torch.float32, device="cuda")
        Pn = Xn.shape[0]
        lag_n = torch.as_tensor(rng.integers(-400, 400, (47, Pn)), dtype=torch.float32,
                                device="cuda")
        s_n = torch.as_tensor(rng.standard_normal((47, 1024, 2)) * 0.5,
                              dtype=torch.float32, device="cuda")
        same_lag(f"P={Pn}", lag_n, Xn, s_n)
    roles = LTS.sweep_roles(sites)
    check_sweep(f"one-band roles {roles:06b}", tau, g["X"], s, pipe.h, pipe.c_steps,
                LTS.refit_contractions(P, "loop"), lag, 1.0 / stf.fs, roles)
    fsites = LTS.delay_contracted(P, "funnel")
    froles = (LTS.sweep_roles(fsites, "single"), LTS.sweep_roles(fsites, None, "survivors"))
    check_funnel("one-band", tau, g["X"], s, g["cand_ok"], pipe.h, pipe.c_steps,
                 max(16, -(-Q // 24)), lag, 1.0 / stf.fs, froles)
    s4, obj = LS.sweep(tau, g["X"], s, pipe.h, pipe.c_steps, LTS.refit_contractions(P, "loop"),
                       True, lag, 1.0 / stf.fs, roles)
    obj = torch.where(g["cand_ok"], obj, torch.full_like(obj, float("inf")))
    check_final(f"one-band roles {LTS.final_roles(sites):02b}", tau, g["X"], obj, s4, pipe.h,
                lag, 1.0 / stf.fs, LTS.final_roles(sites))
    rows = tau[..., 0].numel()
    s1 = s[..., :1, :]                 # the main path's shapes: the final subset
    ms = device_ms(lambda: LS.residuals2_lag(lag, 1.0 / stf.fs, g["X"], s1), reps=20)
    pms = device_ms(lambda: LS.residuals2_lag_reference(
        lag, float(np.float32(1.0 / stf.fs)), g["X"], s1), reps=3)
    flops, nbytes = lts_sweep_work("residuals2_lag", rows, 1, P)
    ops_ms, mem_ms = flops / PEAK_FP32_FLOPS * 1e3, nbytes / PEAK_HBM_BYTES * 1e3
    bound, by = max(ops_ms, mem_ms), ("operations" if ops_ms >= mem_ms else "bytes")
    zero_launches()
    with_lag = cuda_time_ms(lambda: pipe._solve_masked(tau, md), reps=20)
    per_solve = {k: v // 22 for k, v in lts_sweep_launches().items()}
    without = cuda_time_ms(lambda: pipe._solve_masked(tau, md, fused=False), reps=20)
    log(f"[{label}] one-band ltsva ({n} windows of {WINLEN} s, P = {P}, {Q} candidates, "
        f"delay sites {sorted(sites)}): lts_sweep launches {sweep} on the card; stdict "
        f"card = CPU on the {int(same.sum())} of {n} windows with bit-identical delays; "
        f"lts_solve on the CPU's delays and lags bit for bit the CPU's; residuals2_lag "
        f"bit for bit its plain version at P = 15, {P}, 120; sweep bit for "
        f"bit sweep_reference with roles {roles:06b} (exhaustive) and {froles[0]:06b}, "
        f"{froles[1]:06b} (funnel), final bit for bit final_reference with roles "
        f"{LTS.final_roles(sites):02b}; a residuals2_lag launch at the final subset's "
        f"shapes ({rows} x 1 x {P}) {ms:.4f} ms, plain version on the card "
        f"{pms:.4f} ms, bound {bound:.4f} ms by {by} ({flops / 1e6:.1f} MFLOP, "
        f"{nbytes / 1e6:.2f} MB); the one-band solve {with_lag:.4f} ms with the lags "
        f"({per_solve} launches a solve), {without:.4f} ms without (CUDA events, "
        f"20 solves)")
    return {"name": "lts_sweep.residuals2_lag", "route": "cuda", "per": "launch",
            "source": LTS_SWEEP_SOURCE, "replaces": LTS_SWEEP_REPLACES["residuals2_lag"],
            "launches": sweep["residuals2_lag"], "max_abs_err": 0.0, "ms": ms,
            "plain_ms": pms, "bound_ms": bound, "bound_by": by, "library_ms": None}


def _eager_residuals2(tau, X, s):
    """The sweep's residuals as eager PyTorch operations, each rounded on its
    own (the port's code before csrc/lts_sweep.cu): the "before" of
    `lts_before_after`."""
    r = tau[..., None, :] - (X[:, 0] * s[..., 0, None] + X[:, 1] * s[..., 1, None])
    return r * r


def _eager_elemental(tau, cand, Ainv):
    import torch

    tp = tau[..., cand]
    t0, t1 = tp[..., 0], tp[..., 1]
    return torch.stack([Ainv[:, 0, 0] * t0 + Ainv[:, 0, 1] * t1,
                        Ainv[:, 1, 0] * t0 + Ainv[:, 1, 1] * t1], dim=-1)


def _eager_refit(tau, X, weight, eps=1e-12, contract=None):
    import torch
    from narrow_band_least_squares_tpu_torch.ops.solve import tree_sum_last

    Xw = weight[..., None] * X
    m00 = tree_sum_last(Xw[..., 0] * X[..., 0])
    m01 = tree_sum_last(Xw[..., 0] * X[..., 1])
    m11 = tree_sum_last(Xw[..., 1] * X[..., 1])
    b0 = tree_sum_last(weight * tau * X[..., 0])
    b1 = tree_sum_last(weight * tau * X[..., 1])
    det = m00 * m11 - m01 * m01
    ok = torch.abs(det) > eps
    safe = torch.where(ok, det, torch.ones_like(det))
    zero = torch.zeros_like(det)
    return torch.stack([torch.where(ok, (b0 * m11 - b1 * m01) / safe, zero),
                        torch.where(ok, (b1 * m00 - b0 * m01) / safe, zero)], dim=-1)


class SweepRoute:
    """While installed (``with``), runs `ops.lts`'s solve by one of four
    routes: "final" (`lts_sweep.sweep`, one launch a candidate block on the
    route it picks by P, and the final subset in one `lts_sweep.final`
    launch), "sweep" (the same sweep, the final subset on the separate
    passes of `ops.lts._final_passes`: the route before `final`),
    "kernels" (the sweep's plain composition on the separate passes of
    csrc/lts_sweep.cu: residuals2 and refit a C-step, the eager rank
    between them; the route before `sweep`) or "eager" (that composition
    on eager arithmetic, the elemental solves and the final subset too; the
    port before csrc/lts_sweep.cu).  "kernels", "sweep" and "final" give
    the same objective, s and flags; "eager" rounds every operation on its
    own."""

    def __init__(self, route):
        if route not in ("eager", "kernels", "sweep", "final"):
            raise ValueError(f"unknown sweep route {route!r}")
        self.route = route

    def __enter__(self):
        import functools

        from narrow_band_least_squares_tpu_torch.ops.kernels import lts_sweep as LS

        self._LS = LS
        self._saved = (LS.sweep, LS.residuals2, LS.refit, LS.elemental, LS.final_route)
        if self.route != "final":
            LS.final_route = lambda P, dtype: "passes"
        if self.route == "kernels":
            LS.sweep = functools.partial(
                LS.sweep_reference, passes=(LS.residuals2, LS.residuals2_lag, LS.refit))
        elif self.route == "eager":
            LS.sweep = functools.partial(
                LS.sweep_reference, passes=(_eager_residuals2, LS.residuals2_lag,
                                            _eager_refit))
            LS.residuals2, LS.refit, LS.elemental = (_eager_residuals2, _eager_refit,
                                                     _eager_elemental)
        return self

    def __exit__(self, *exc):
        LS = self._LS
        LS.sweep, LS.residuals2, LS.refit, LS.elemental, LS.final_route = self._saved


def step_peak_mib(step):
    """Peak device memory (MiB) of one ``step()`` above what was held before
    it, and what was held."""
    import torch

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    step()
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - base) / 2**20, base / 2**20


def lts_before_after(label, st, freqlist, winlens):
    """The canonical LTS step (exhaustive) by each `SweepRoute`, in turns
    eager, kernels, sweep, final, final, sweep, kernels, eager: step ms by
    CUDA events over 20 steps, the solve's device time and kernel count in
    one profiled solve, and the step's peak memory."""
    from narrow_band_least_squares_tpu_torch.models import NarrowBandPipeline
    from narrow_band_least_squares_tpu_torch.utils import get_rij, make_plan

    plan = make_plan(freqlist, "log", winlens, WINOVER, st.npts, st.fs)
    pipe = NarrowBandPipeline(plan, get_rij(st.latitudes, st.longitudes, st.nchans),
                              alpha=LTS_ALPHA, device="cuda")
    tau, _, md = pipe._delays(pipe._filter(pipe._to_device(st.data)))
    order = ("eager", "kernels", "sweep", "final")
    out = {r: [] for r in order}
    for route in order + order[::-1]:
        with SweepRoute(route):
            step = cuda_time_ms(lambda: pipe.run_raw(st.data), reps=20)
            busy, rows = profile_once(lambda: pipe._solve_masked(tau, md))
            peak, _ = step_peak_mib(lambda: pipe.run_raw(st.data))
        out[route].append((step, busy, sum(r[2] for r in rows), peak))
    for route, vals in out.items():
        log(f"[{label}] lts canonical exhaustive step, sweep route {route}: "
            + "; ".join(f"{a:.4f} ms a step (CUDA events, 20 steps), solve {b:.4f} ms "
                        f"of device time in {c} kernels (one profiled solve), peak "
                        f"{p:.1f} MiB above the step's inputs" for a, b, c, p in vals))


def phase_lts(label):
    """Canonical LTS with one incoherent element through the API, card
    against CPU, exhaustive and with PRODUCTION_DEFAULTS; the lts_sweep
    kernels against their plain versions, `sweep` at every thread-route
    size, its warp and thread routes in turns, `final` in every cell that
    reaches it; the capped-candidate case card against CPU; one-band ltsva
    card against CPU (`lts_one_band`) and at P = 120; multi-array and
    large-array LTS; the LTS timings, the solve before and after its
    kernels.  Returns the kernels-line records of lts_sweep, their launches
    from the runs of the paths that launch them: sweep, elemental and final
    from the exhaustive API run, residuals2 and refit from the large array
    (P = 120, whose final subset takes the separate passes), residuals2_lag
    from its one-band run."""
    st, freqlist, winlens = canonical_inputs(outlier_channels=(LTS_OUTLIER,))
    recs = lts_kernel_check(label, st, freqlist, winlens)
    recs.append(lts_final_check(label, st))
    lts_sweep_sizes(label)
    routes = lts_sweep_routes(label, st)
    for r in recs:
        if r["name"] == "lts_sweep.sweep":     # the thread route at P = 28
            r.update(sweep_route="thread", warp_ms=sum(routes["warp"]) / 2)
    launches = {}
    for production in (False, True):
        tag = "lts production" if production else "lts exhaustive"
        gpu, tau_g, secs, sweep = run_api_lts(st, freqlist, winlens, "cuda", production)
        cpu, tau_c, secs_cpu, _ = run_api_lts(st, freqlist, winlens, "cpu", production)
        log(f"{tag}: first API call {secs:.3f} s on the card, {secs_cpu:.3f} s on "
            f"the CPU (host set-up included)")
        ncl = gpu[6]
        check_shapes(gpu, ncl, NBANDS)
        compare_lts(gpu, cpu, tau_g, tau_c, ncl, tag)
        ground_truth(gpu, ncl, label=f"{tag} ")
        check_outlier(gpu[4], NCHANS, LTS_OUTLIER, tag)
        if not production:
            launches.update({k: (sweep[k], "the canonical exhaustive API run")
                             for k in ("sweep", "elemental", "final")})
    lts_capped_case(label)
    recs.append(lts_one_band(label, st))
    lts_rank_check(label, st, freqlist, winlens)
    lts_multiarray()
    large = lts_large_array()
    launches.update({k: (large[k], "the large-array run (P = 120)")
                     for k in ("residuals2", "refit")})
    launches["residuals2_lag"] = (lts_one_band_large(label)["residuals2_lag"],
                                  "one-band ltsva at P = 120")
    for r in recs:
        r["launches"], r["launches_run"] = launches[r["name"].split(".")[1]]
    lts_before_after(label, st, freqlist, winlens)
    lts_timing(label, st)
    return recs


# --------------------------------------------------------------------------
# the streaming monitor
# --------------------------------------------------------------------------

def monitor_inputs(hours, outlier_channels=()):
    """examples/example_monitoring.py's workload: 8 elements at 20 Hz for
    ``hours``, the canonical 8-band plan on 1200 s segments."""
    from narrow_band_least_squares_tpu_torch.io import synthetic_plane_wave
    from narrow_band_least_squares_tpu_torch.utils import (
        get_freqlist, get_rij, get_winlenlist, make_plan,
    )

    st = synthetic_plane_wave(
        nchans=NCHANS, duration_s=hours * 3600.0, fs=FS, baz_deg=BAZ_TRUE,
        trace_vel_kms=VEL_TRUE, f0=0.8, bandwidth=1.4, snr=6.0, seed=SEED,
        outlier_channels=outlier_channels,
    )
    freqlist, nbands, _ = get_freqlist(FMIN, FMAX, "log", NBANDS)
    winlens = get_winlenlist("adaptive", nbands, WINLEN, WINLEN_1, WINLEN_X)
    plan = make_plan(freqlist, "log", winlens, WINOVER, int(MONITOR_SEGMENT_S * FS), FS)
    return st, plan, get_rij(st.latitudes, st.longitudes, st.nchans), freqlist


class RetryCounter:
    """While installed (``with``), counts the warnings the monitor logs: a
    failed dispatch, a retry, a failed attempt."""

    def __enter__(self):
        import logging

        self.n = 0
        self.logger = logging.getLogger("nbls_torch.streaming")
        counter = self

        class Handler(logging.Handler):
            def emit(self, record):
                if record.levelno >= logging.WARNING:
                    counter.n += 1

        self.handler = Handler()
        self.logger.addHandler(self.handler)
        return self

    def __exit__(self, *exc):
        self.logger.removeHandler(self.handler)


def segment_npz(path):
    with np.load(path) as z:
        return {k: z[k] for k in ("vel", "baz", "mdccm", "sig_tau", "flags")}


def guarded(out, keys=("vel", "baz", "mdccm", "sig_tau")):
    """Outputs as the monitor persists them: float64, non-finite as 0."""
    return {k: np.where(np.isfinite(out[k]), out[k], 0.0).astype(np.float64)
            for k in keys}


def monitor_run(label, st, plan, rij, freqlist, workdir, name, warm=True, **kw):
    """One monitor over ``st`` on the card in a fresh directory, after a
    warm-up monitor on its first batch (another directory).  Checks that no
    retry was logged.  Returns (monitor, records, seconds of process(),
    launches by route)."""
    import shutil

    import torch
    from narrow_band_least_squares_tpu_torch.models import StreamingMonitor

    def make(d):
        shutil.rmtree(d, ignore_errors=True)
        return StreamingMonitor(plan, rij, d, freqlist, dispatch_segments=MONITOR_DISPATCH,
                                device="cuda", **kw)

    if warm:
        make(os.path.join(workdir, name + "-warm")).process(
            st.slice_samples(0, MONITOR_DISPATCH * plan.npts))
    mon = make(os.path.join(workdir, name))
    torch.cuda.synchronize()
    with RetryCounter() as retries:
        zero_launches()
        t0 = time.perf_counter()
        recs = mon.process(st)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = lag_search_launches()
        mon.close()
    if retries.n:
        fail(f"monitor {name}: {retries.n} failed dispatches or retries were logged")
    nseg = len(mon.segment_starts(st))
    if len(recs) != nseg:
        fail(f"monitor {name}: {len(recs)} segments persisted, not {nseg}")
    nwin = nseg * sum(plan.num_compute_list)
    log(f"[{label}] monitor {name}: process() of {nseg} segments of "
        f"{plan.npts} samples in batches of {mon.batch}: {secs:.4f} s, "
        f"{nseg / secs:.2f} segments/s, {nwin / secs:.1f} windows solved/s; "
        f"launches icorr_peak fp32 {counts[0]} / tensor-core {counts[1]}, "
        f"fused_xcorr_bucket fp32 {counts[2]} / tensor-core {counts[3]}; no retry")
    return mon, recs, secs, counts


def check_monitor_launches(name, counts, method, nbatches):
    """(e): the method's tensor-core route once per bucket of each batch,
    nothing else (the prediction in PERF.md)."""
    want = nbatches * CANONICAL_BUCKETS
    expect = (0, want, 0, 0) if method == "mxu" else (0, 0, 0, want)
    if counts != expect:
        fail(f"monitor {name}: launches {counts}, predicted {expect} ({nbatches} "
             f"batches x {CANONICAL_BUCKETS} buckets)")


def check_monitor_cpu(name, st, plan, rij, recs, method, segs=(0, 1, -1)):
    """(a): the card's persisted segments (cold, first warm, last) against
    the port's run_extended of the same segments on the CPU."""
    from narrow_band_least_squares_tpu_torch.parallel import ShardedNarrowBandPipeline

    cpu = ShardedNarrowBandPipeline(plan, rij, xcorr_method=method, device="cpu")
    idx = [s % len(recs) for s in segs]
    out = cpu.run_extended(cpu.extend_segments(st.data, [i * plan.npts for i in idx]))
    ncl = plan.num_compute_list
    for k, i in enumerate(idx):
        z = segment_npz(recs[i].path_npz)
        c = guarded({n: v[k] for n, v in out.items()})
        compare_outputs((z["vel"], z["baz"], z["mdccm"], None, None, z["sig_tau"]),
                        (c["vel"], c["baz"], c["mdccm"], None, None, c["sig_tau"]), ncl,
                        label=f"monitor {name} segment {i}")


def check_monitor_run(name, mon, st, recs, exact):
    """(b): the persisted segments against ``pipe.run`` of the whole stream
    in one batch on the card, bit for bit (``exact``) or within
    MONITOR_RUN_TOL."""
    out = guarded(mon.pipe.run(mon.pipe.segment_stream(st.data)))
    W = mon.plan.max_windows
    worst, unequal = 0.0, 0
    for s, rec in enumerate(recs):
        z = segment_npz(rec.path_npz)
        for k, v in out.items():
            a, b = z[k][:, :W], v[s]
            d = np.abs(a - b)
            worst = max(worst, float(d.max()))
            unequal += int((a != b).sum())
            if exact and unequal:
                fail(f"monitor {name}: segment {s} {k} differs from pipe.run by up "
                     f"to {float(d.max()):.3e} ({unequal} values)")
            if (d > MONITOR_RUN_TOL + MONITOR_RUN_TOL * np.abs(b)).any():
                fail(f"monitor {name}: segment {s} {k} differs from pipe.run beyond "
                     f"{MONITOR_RUN_TOL} (max {float(d.max()):.3e})")
    log(f"monitor {name} against pipe.run of all {len(recs)} segments in one "
        f"batch: " + ("bit for bit" if exact else
                      f"within {MONITOR_RUN_TOL} (max abs diff {worst:.3e}, "
                      f"{unequal} values not bit-equal)"))


def fft_batch_bits(mon, st):
    """Logs whether cuFFT's bits for one segment's filter bank depend on
    the batch count: segment 0 filtered alone (as the segment step does)
    against filtered in one batched call with the other segments."""
    import torch

    pipe, base = mon.pipe, mon.pipe.base
    x = torch.as_tensor(pipe._chain_halos(pipe.segment_stream(st.data)), device="cuda")
    S, C, T = x.shape
    alone = base._filter(x[0], nfft=pipe.nfft_ext, halo=pipe.halo)
    batched = base._filter(x.reshape(S * C, T), nfft=pipe.nfft_ext, halo=pipe.halo)[:, :C]
    d = (alone - batched).abs()
    log(f"filter bank of segment 0 alone against in one cuFFT batch of {S} segments: "
        f"{int((alone != batched).sum())} of {alone.numel()} values differ, max abs "
        f"diff {float(d.max()):.3e} (largest |value| {float(alone.abs().max()):.3e})")


def check_monitor_resume(name, mon, st, recs, exact):
    """(d): a second process() does nothing; a deleted segment is redone
    alone, its .txt byte-identical (``exact``) or within MONITOR_RUN_TOL."""
    from narrow_band_least_squares_tpu_torch.io import read_txtfile

    if mon.process(st) != []:
        fail(f"monitor {name}: a second process() redid persisted segments")
    rec = recs[5]
    with open(rec.path_txt, "rb") as f:
        before = f.read()
    old = read_txtfile(mon.save_dir, os.path.basename(rec.path_txt)[:-4])
    os.remove(rec.path_txt)
    redo = mon.process(st)
    mon.close()
    if len(redo) != 1 or redo[0].start_epoch != rec.start_epoch:
        fail(f"monitor {name}: deleting segment 5 redid {len(redo)} segments")
    with open(redo[0].path_txt, "rb") as f:
        after = f.read()
    new = read_txtfile(mon.save_dir, os.path.basename(rec.path_txt)[:-4])
    worst = max(float(np.abs(a - b).max()) for a, b in zip(new[:4], old[:4]))
    if exact and after != before:
        fail(f"monitor {name}: the redone segment's .txt is not byte-identical "
             f"(max abs diff {worst:.3e})")
    if any((np.abs(a - b) > MONITOR_RUN_TOL + MONITOR_RUN_TOL * np.abs(b)).any()
           for a, b in zip(new[:4], old[:4])):
        fail(f"monitor {name}: the redone segment differs beyond {MONITOR_RUN_TOL} "
             f"(max abs diff {worst:.3e})")
    log(f"monitor {name} resume: a second process() did nothing; the deleted "
        f"segment 5 was redone alone, its .txt "
        + ("byte-identical" if after == before else
           f"within {MONITOR_RUN_TOL} (max abs diff {worst:.3e})"))


def monitor_batch_times(label, mon, st, method):
    """One batch of MONITOR_DISPATCH segments (``run_extended_async``: the
    copy in and the segment step) by CUDA events over batches as the host
    issues them, and its device busy time (torch.profiler), beside
    MONITOR_DISPATCH x the canonical run_raw step of the same method."""
    import torch
    from narrow_band_least_squares_tpu_torch.models import NarrowBandPipeline

    pipe = mon.pipe
    x4 = pipe.extend_segments(st.data, [k * pipe.plan.npts for k in range(MONITOR_DISPATCH)])
    ev = cuda_time_ms(lambda: pipe.run_extended_async(x4), reps=10)
    busy, rows = profile_once(lambda: pipe.run_extended_async(x4))
    one = NarrowBandPipeline(pipe.plan, pipe.base.rij, xcorr_method=method, device="cuda")
    seg = st.data[:, : pipe.plan.npts]
    step_ev = cuda_time_ms(lambda: one.run_raw(seg), reps=20)
    step_busy, step_rows = profile_once(lambda: one.run_raw(seg))
    xd = torch.as_tensor(x4, device="cuda")
    base, T = pipe.base, x4.shape[2]
    per_seg = cuda_time_ms(lambda: [base._filter(row, nfft=pipe.nfft_ext, halo=pipe.halo)
                                    for row in xd], reps=10)
    batched = cuda_time_ms(lambda: base._filter(xd.reshape(-1, T), nfft=pipe.nfft_ext,
                                                halo=pipe.halo), reps=10)
    n = MONITOR_DISPATCH
    log(f"[{label}] monitor {method}: the filter bank of a batch of {n} segments "
        f"{per_seg:.4f} ms one segment at a time (as the segment step runs it), "
        f"{batched:.4f} ms in one cuFFT batch (CUDA events over 10 batches)")
    log(f"[{label}] monitor {method} at high: one batch of {n} segments "
        f"{ev:.4f} ms by events, device busy {busy:.4f} ms in "
        f"{sum(r[2] for r in rows)} kernels and copies; {n} x the canonical "
        f"run_raw step {n * step_ev:.4f} ms by events, device busy "
        f"{n * step_busy:.4f} ms in {n * sum(r[2] for r in step_rows)}")


def monitor_profile(label, st, plan, rij, freqlist, workdir):
    """Where ``process()`` spends its time ('mxu', 'high'): the device busy
    share of one whole process() (torch.profiler), and one at a time the
    host's parts of a batch: cutting the halo-extended segments, the
    segment step to the host copy (run_extended, synchronous), and
    persisting a segment (npz and TSV)."""
    import torch
    from narrow_band_least_squares_tpu_torch.models import StreamingMonitor

    mon = StreamingMonitor(plan, rij, os.path.join(workdir, "profiled"), freqlist,
                           dispatch_segments=MONITOR_DISPATCH, device="cuda")
    torch.cuda.synchronize()
    wall = []
    busy, _ = device_profile(lambda: wall.append(wall_s(lambda: mon.process(st))))
    wall = wall[0]
    offs = [k * plan.npts for k in range(MONITOR_DISPATCH)]

    def mean_s(fn, reps=5):
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / reps

    t_cut = mean_s(lambda: mon.pipe.extend_segments(st.data, offs))
    x4 = mon.pipe.extend_segments(st.data, offs)
    t_step = mean_s(lambda: mon.pipe.run_extended(x4))
    out = mon.pipe.run_extended(x4)
    t_write = mean_s(lambda: [mon._persist_segment(out, s, 1e9 + s) for s in range(len(offs))])
    nb = -(-len(mon.segment_starts(st)) // MONITOR_DISPATCH)
    log(f"[{label}] monitor profile (mxu, high): process() wall {wall * 1e3:.2f} ms "
        f"under the profiler, device busy {busy * 1e3:.2f} ms "
        f"({100 * busy / wall:.1f}%); a batch of {len(offs)} on the host, one part at a "
        f"time: cut {t_cut * 1e3:.2f} ms, run_extended {t_step * 1e3:.2f} ms, persist "
        f"{t_write * 1e3:.2f} ms ({nb} batches)")


def monitor_lts(label, workdir):
    """(g): LTS monitor ('mxu', ALPHA = LTS_ALPHA, element 3 incoherent) on
    MONITOR_LTS_HOURS: the persisted flags equal the CPU's on every valid
    window whose delays are bit-identical (at least LTS_SAME_MIN of them),
    and element 3 is the most flagged."""
    from narrow_band_least_squares_tpu_torch.parallel import ShardedNarrowBandPipeline

    st, plan, rij, freqlist = monitor_inputs(MONITOR_LTS_HOURS,
                                             outlier_channels=(LTS_OUTLIER,))
    with LtsRecorder() as rec:
        mon, recs, _, counts = monitor_run(label, st, plan, rij, freqlist, workdir,
                                           "lts-mxu", warm=False, alpha=LTS_ALPHA)
        tau_g = rec.taus[: len(recs)]
    nb = -(-len(recs) // MONITOR_DISPATCH)
    check_monitor_launches("lts-mxu", counts, "mxu", nb)
    cpu = ShardedNarrowBandPipeline(plan, rij, alpha=LTS_ALPHA, device="cpu")
    with LtsRecorder() as rec:
        out = cpu.run_extended(cpu.extend_segments(
            st.data, [k * plan.npts for k in range(len(recs))]))
        tau_c = rec.taus
    wm = cpu.base.state_dict()["win_mask"].numpy()
    n_same = n_valid = 0
    for s, r in enumerate(recs):
        z = segment_npz(r.path_npz)
        same = (tau_g[s] == tau_c[s]).all(-1) & wm
        n_same += int(same.sum())
        n_valid += int(wm.sum())
        bad = (z["flags"] != out["flags"][s]).any(-1) & same
        if bad.any():
            fail(f"monitor lts segment {s}: {int(bad.sum())} windows with "
                 f"bit-identical delays flag other pairs on the card than on the CPU")
    share = n_same / n_valid
    log(f"monitor lts: {n_same}/{n_valid} = {share:.4f} valid windows with "
        f"bit-identical delays on the card and the CPU; on all of them equal flags")
    if share < LTS_SAME_MIN:
        fail(f"monitor lts: fewer than {LTS_SAME_MIN:.0%} of the valid windows have "
             f"bit-identical delays")
    flags = mon.read_all(extras=True)[5]["flags"]
    per = np.zeros(NCHANS, dtype=np.int64)
    for p, (i, j) in enumerate(mon.pipe.base.pairs_np):
        per[i] += flags[..., p].sum()
        per[j] += flags[..., p].sum()
    log(f"monitor lts: flags per element (1-based 1..{NCHANS}) {per.tolist()}")
    if per.argmax() != LTS_OUTLIER:
        fail(f"monitor lts: element {per.argmax() + 1} is the most flagged, not "
             f"{LTS_OUTLIER + 1}")


def bf16_envelope(ref, got):
    """(h): tests/test_streaming.py:221-240's envelope of the bfloat16 wire
    against the float32 wire."""
    v1, b1, m1, _, n1 = ref[:5]
    v2, b2, m2, _, n2 = got[:5]
    if n1 != n2:
        fail("monitor bf16: window counts differ from the float32 wire")
    good = (m1 > MDCCM_THRESH) & (m2 > MDCCM_THRESH)
    d = np.abs((b1[good] - b2[good] + 180.0) % 360.0 - 180.0)
    dv = np.median(np.abs(v1[good] - v2[good]))
    log(f"monitor bf16 wire against float32: {int(good.sum())} confident windows, "
        f"median |d baz| {np.median(d):.4f} deg (max {d.max():.4f}), median "
        f"|d vel| {dv:.6f} km/s")
    if good.sum() <= 10 or np.median(d) >= 1.0 or d.max() >= 10.0 or dv >= 0.01:
        fail("monitor bf16: outside the envelope of tests/test_streaming.py:221")


def phase_monitor(label):
    """examples/example_monitoring.py on the card: 'mxu' and 'fused' at
    'high', checks (a)-(f), a bfloat16 wire (h), an LTS monitor (g), and
    the throughput and batch times."""
    import shutil

    workdir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                           "monitor_smoke")
    shutil.rmtree(workdir, ignore_errors=True)
    st, plan, rij, freqlist = monitor_inputs(MONITOR_HOURS)
    nbatches = -(-(st.npts // plan.npts) // MONITOR_DISPATCH)
    for method in ("mxu", "fused"):
        mon, recs, _, counts = monitor_run(label, st, plan, rij, freqlist, workdir,
                                           method, xcorr_method=method)
        check_monitor_launches(method, counts, method, nbatches)
        check_monitor_cpu(method, st, plan, rij, recs, method)
        check_monitor_run(method, mon, st, recs, exact=method == "fused")
        if method == "fused":
            fft_batch_bits(mon, st)
        res = mon.read_all(extras=True)
        ground_truth(res, res[4], label=f"monitor {method} ")
        check_monitor_resume(method, mon, st, recs, exact=method == "fused")
        if method == "mxu":
            ref = res
        monitor_batch_times(label, mon, st, method)
    mon, _, _, _ = monitor_run(label, st, plan, rij, freqlist, workdir, "mxu-bf16",
                               transfer_dtype="bfloat16")
    bf16_envelope(ref, mon.read_all())
    monitor_profile(label, st, plan, rij, freqlist, workdir)
    monitor_lts(label, workdir)
    shutil.rmtree(workdir, ignore_errors=True)


# --------------------------------------------------------------------------
# ingest: miniSEED -> StreamingIngest -> the monitor on the card
# --------------------------------------------------------------------------

def native_lib():
    """The port's native runtime (miniSEED codec, ring buffer, TSV codec):
    built from the checkout's sources, or the run fails."""
    from narrow_band_least_squares_tpu_torch import native

    lib = native.get_lib()
    if lib is None:
        fail(f"the native runtime did not build: {native.build_error}")
    return lib


def round_half_away(x):
    """The encoder's rounding to counts (``native/ingest.cpp``)."""
    return np.where(x < 0, np.trunc(x - 0.5), np.trunc(x + 0.5))


def ingest_records(st, workdir):
    """The monitor stream as a station would deliver it: Steim1 512-byte
    records written by the port's ``write_mseed`` at a power-of-two scale
    (exact in float64) whose peak is near INGEST_PEAK_COUNTS counts, then
    decoded by the port's reader.  Checks every channel against
    round(data x scale) exactly.  Returns (records, the decoded stream,
    scale, (bytes, records, seconds to encode, seconds to decode))."""
    from narrow_band_least_squares_tpu_torch.io.ingest import (
        mseed_to_stream, read_mseed, read_mseed_records, write_mseed,
    )

    st = st.copy()
    st.ids = [f"XX.E{c:02d}..BDF" for c in range(st.nchans)]   # NET.STA.LOC.CHA
    peak = float(np.abs(st.data).max())
    scale = 2.0 ** int(np.floor(np.log2(INGEST_PEAK_COUNTS / peak)))
    counts = round_half_away(st.data * scale)
    quant = (1.0 / np.sqrt(12.0)) / scale          # rms of the rounding
    rms = float(np.sqrt(np.mean(st.data ** 2)))
    path = os.path.join(workdir, "monitor.mseed")
    t0 = time.perf_counter()
    nbytes = write_mseed(path, st, scale=scale)
    t_enc = time.perf_counter() - t0
    with open(path, "rb") as f:
        raw = f.read()
    reps, t0 = 3, time.perf_counter()
    for _ in range(reps):
        recs = read_mseed_records(raw)
    t_dec = (time.perf_counter() - t0) / reps
    if [(r.sid, r.t0, r.samples.tolist()[:3]) for r in read_mseed(path)[:3]] != \
            [(r.sid, r.t0, r.samples.tolist()[:3]) for r in recs[:3]]:
        fail("ingest: read_mseed and read_mseed_records disagree")
    coords = dict(zip(st.ids, zip(st.latitudes, st.longitudes)))
    dec = mseed_to_stream(recs, coords)
    if dec.ids != list(st.ids) or dec.npts != st.npts:
        fail(f"ingest: the decoded stream has ids {dec.ids[:2]}.. and {dec.npts} "
             f"samples, not {st.ids[:2]}.. and {st.npts}")
    bad = int((dec.data != counts).sum())
    if bad:
        fail(f"ingest: {bad} decoded samples differ from round(data x scale)")
    log(f"ingest: scale {scale:g} counts per unit (peak {peak * scale:.0f} counts); "
        f"quantisation rms {quant:.3e} against the data's rms {rms:.3e} "
        f"({quant / rms:.2e} of it); {len(recs)} Steim1 records of 512 B, "
        f"{nbytes} B; every channel decodes to round(data x scale) exactly")
    if quant > 1e-3 * rms:
        fail("ingest: the quantisation is not under the noise")
    return recs, dec, scale, (nbytes, len(recs), t_enc, t_dec)


def arrival_order(records):
    """examples/example_streaming_ingest.py:58-68's telemetry: each channel
    lags 0-2 records (rng seed 0); records sorted by index plus lag."""
    rng = np.random.default_rng(0)
    by_sid = {}
    for r in records:
        by_sid.setdefault(r.sid, []).append(r)
    keyed = []
    for sid in by_sid:
        lag = int(rng.integers(0, 3))
        keyed += [(k + lag, r) for k, r in enumerate(by_sid[sid])]
    keyed.sort(key=lambda kr: kr[0])
    return [r for _, r in keyed]


def ingest_feed(st, plan, rij, freqlist, feed, workdir, name, method):
    """Feed ``feed`` into the port's StreamingIngest INGEST_PACKET records
    at a time; after each packet every ready segment goes to a
    ``StreamingMonitor(..., device="cuda", dispatch_segments=4)`` with the
    segment before it, so the monitor cuts the filter halo from real data
    (the earlier segment is queued or persisted already and is skipped).
    Returns (monitor, its records in segment order, the segments, the
    ingest, seconds of feeding, of emission, of the whole loop to the last
    persisted file, launches by route, TSV files by codec)."""
    import shutil

    import torch
    from narrow_band_least_squares_tpu_torch.io import ArrayStream, textio
    from narrow_band_least_squares_tpu_torch.io.ingest import StreamingIngest
    from narrow_band_least_squares_tpu_torch.models import StreamingMonitor

    def monitor(d):
        shutil.rmtree(d, ignore_errors=True)
        return StreamingMonitor(plan, rij, d, freqlist, dispatch_segments=MONITOR_DISPATCH,
                                device="cuda", xcorr_method=method)

    warm = monitor(os.path.join(workdir, name + "-warm"))
    warm.process(st.slice_samples(0, MONITOR_DISPATCH * plan.npts))
    warm.close()
    mon = monitor(os.path.join(workdir, name))
    ing = StreamingIngest(st.ids, fs=st.fs, segment_npts=plan.npts,
                          latitudes=st.latitudes, longitudes=st.longitudes)
    if not ing.ring.is_native:
        fail(f"ingest {name}: the ring buffer is not native")
    segs, prev = [], None
    t_feed = t_emit = 0.0
    torch.cuda.synchronize()
    with RetryCounter() as retries:
        zero_launches()
        before = dict(textio.codec_writes)
        t_all = time.perf_counter()
        for i in range(0, len(feed), INGEST_PACKET):
            t0 = time.perf_counter()
            ing.feed_records(feed[i:i + INGEST_PACKET])
            t1 = time.perf_counter()
            ready = list(ing.ready_segments())
            t_feed += t1 - t0
            t_emit += time.perf_counter() - t1
            for seg in ready:
                segs.append(seg)
                sub = seg if prev is None else ArrayStream(
                    data=np.concatenate([prev.data, seg.data], axis=1), fs=seg.fs,
                    start_epoch=prev.start_epoch, latitudes=seg.latitudes,
                    longitudes=seg.longitudes, ids=seg.ids)
                mon.submit(sub)
                prev = seg
        recs = mon.close()
        torch.cuda.synchronize()
        t_all = time.perf_counter() - t_all
        counts = lag_search_launches()
        codecs = {k: v - before[k] for k, v in textio.codec_writes.items()}
    if retries.n:
        fail(f"ingest {name}: {retries.n} failed dispatches or retries were logged")
    return mon, recs, segs, ing, t_feed, t_emit, t_all, counts, codecs


def check_ingest_segments(name, segs, ing, dec, plan):
    """(1): every segment bit for bit the decoded stream's slice, nothing
    dropped, the ring native."""
    nseg = dec.npts // plan.npts
    if len(segs) != nseg:
        fail(f"ingest {name}: {len(segs)} segments emitted, not {nseg}")
    for s, seg in enumerate(segs):
        want = dec.data[:, s * plan.npts:(s + 1) * plan.npts]
        if not np.array_equal(seg.data, want) or seg.start_epoch != \
                dec.start_epoch + s * plan.npts / dec.fs:
            fail(f"ingest {name}: segment {s} is not the decoded stream's slice")
    if ing.dropped_records != 0 or not ing.ring.is_native:
        fail(f"ingest {name}: dropped_records {ing.dropped_records}, native ring "
             f"{ing.ring.is_native}")
    log(f"ingest {name}: {len(segs)} segments, each bit for bit the decoded stream's "
        f"slice; dropped_records 0; native ring")


def check_ingest_against_process(name, recs, ref_recs, exact):
    """(2): the persisted results against process() of the decoded stream
    as a whole, bit for bit (``exact``) or within MONITOR_RUN_TOL."""
    if len(recs) != len(ref_recs):
        fail(f"ingest {name}: {len(recs)} segments persisted, process() {len(ref_recs)}")
    worst, unequal = 0.0, 0
    for s, (a, b) in enumerate(zip(recs, ref_recs)):
        if a.start_epoch != b.start_epoch:
            fail(f"ingest {name}: segment {s} starts at {a.start_epoch}, process()'s "
                 f"at {b.start_epoch}")
        za, zb = segment_npz(a.path_npz), segment_npz(b.path_npz)
        for k in ("vel", "baz", "mdccm", "sig_tau"):
            d = np.abs(za[k] - zb[k])
            worst = max(worst, float(d.max()))
            unequal += int((za[k] != zb[k]).sum())
            if (d > MONITOR_RUN_TOL + MONITOR_RUN_TOL * np.abs(zb[k])).any():
                fail(f"ingest {name}: segment {s} {k} differs from process() beyond "
                     f"{MONITOR_RUN_TOL} (max {float(d.max()):.3e})")
    if exact and unequal:
        fail(f"ingest {name}: {unequal} values differ from process() (max {worst:.3e})")
    log(f"ingest {name} against process() of the decoded stream: "
        + ("bit for bit" if not unequal else
           f"within {MONITOR_RUN_TOL} (max abs diff {worst:.3e}, {unequal} values "
           f"not bit-equal)"))


def check_ingest_codec(name, mon, recs, codecs):
    """(6): every .txt of the run written by the C++ codec; segment 0's
    .txt byte for byte the Python codec's for the same arrays."""
    from narrow_band_least_squares_tpu_torch.io import textio

    if codecs != {"native": len(recs), "python": 0}:
        fail(f"ingest {name}: TSV files by codec {codecs}, not {len(recs)} native")
    with np.load(recs[0].path_npz) as z:
        arrs = [z[k] for k in ("vel", "baz", "mdccm", "t")]
    ref = textio.write_txtfile(os.path.dirname(recs[0].path_txt), "python-codec",
                               *arrs, mon.freqlist, mon.plan.num_compute_list,
                               use_native=False)
    with open(recs[0].path_txt, "rb") as f, open(ref, "rb") as g:
        same = f.read() == g.read()
    os.remove(ref)
    if not same:
        fail(f"ingest {name}: segment 0's .txt differs from the Python codec's bytes")
    log(f"ingest {name}: all {len(recs)} .txt written by the C++ codec; segment 0's "
        f"byte for byte the Python codec's")


def persist_times(label, mon, st, plan, rec0):
    """A batch of MONITOR_DISPATCH segments persisted (npz and TSV), with
    the C++ TSV codec and with the Python one, in turns (native, Python,
    Python, native), one part at a time as PERF.md's F2 split it, beside the
    segment step (run_extended) of the same batch; and process() of the
    stream with each codec.  Returns {name: ms or segments/s}."""
    import functools
    import shutil

    import torch
    from narrow_band_least_squares_tpu_torch.io import textio
    from narrow_band_least_squares_tpu_torch.models import StreamingMonitor
    from narrow_band_least_squares_tpu_torch.models import streaming

    offs = [k * plan.npts for k in range(MONITOR_DISPATCH)]
    x4 = mon.pipe.extend_segments(st.data, offs)
    out = mon.pipe.run_extended(x4)
    reps = 5

    def mean_ms(fn):
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / reps * 1e3

    native_writer = streaming.write_txtfile
    python_writer = functools.partial(textio.write_txtfile, use_native=False)

    def persist():
        for s in range(MONITOR_DISPATCH):
            mon._persist_segment(out, s, 2e9 + s)

    res = {"step": mean_ms(lambda: mon.pipe.run_extended(x4))}
    times = {"native": [], "python": []}
    try:
        for codec in ("native", "python", "python", "native"):
            streaming.write_txtfile = native_writer if codec == "native" else python_writer
            times[codec].append(mean_ms(persist))
        for codec in ("native", "python"):
            streaming.write_txtfile = native_writer if codec == "native" else python_writer
            d = os.path.join(os.path.dirname(mon.save_dir), f"process-{codec}")
            shutil.rmtree(d, ignore_errors=True)
            m = StreamingMonitor(plan, mon.pipe.base.rij, d, mon.freqlist,
                                 dispatch_segments=MONITOR_DISPATCH, device="cuda")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            n = len(m.process(st))
            torch.cuda.synchronize()
            res[f"process_{codec}"] = n / (time.perf_counter() - t0)
            m.close()
    finally:
        streaming.write_txtfile = native_writer
    for codec, ts in times.items():
        res[f"persist_{codec}"] = float(np.mean(ts))
    with np.load(rec0.path_npz) as z:
        arrs = [z[k] for k in ("vel", "baz", "mdccm", "t")]
    tsv = {}
    for codec in ("native", "python", "python", "native"):
        tsv.setdefault(codec, []).append(mean_ms(lambda: [textio.write_txtfile(
            mon.save_dir, f"tsv-{codec}-{s}", *arrs, mon.freqlist,
            plan.num_compute_list, use_native=codec == "native")
            for s in range(MONITOR_DISPATCH)]))
    for codec, ts in tsv.items():
        res[f"tsv_{codec}"] = float(np.mean(ts))
    log(f"[{label}] ingest persistence of a batch of {MONITOR_DISPATCH} segments "
        f"(npz + TSV, host, mean of {reps} x 2 in turns): C++ codec "
        f"{res['persist_native']:.2f} ms (runs {times['native'][0]:.2f} / "
        f"{times['native'][1]:.2f}), Python codec {res['persist_python']:.2f} ms "
        f"({times['python'][0]:.2f} / {times['python'][1]:.2f}); the TSV alone "
        f"{res['tsv_native']:.2f} against {res['tsv_python']:.2f} ms; the segment "
        f"step (run_extended) {res['step']:.2f} ms")
    log(f"[{label}] ingest process() of the decoded stream ('mxu', 'high'): "
        f"{res['process_native']:.2f} segments/s with the C++ codec, "
        f"{res['process_python']:.2f} with the Python codec; the step's pace "
        f"{MONITOR_DISPATCH / res['step'] * 1e3:.2f} segments/s")
    return res


def phase_ingest(label):
    """The monitor's 6 h stream as a station would deliver it: Steim1
    records, decoded by the port, fed in arrival order through the native
    ring into StreamingMonitor(..., device="cuda") with 'mxu' and 'fused'
    at 'high'; checks (1)-(6) and the times."""
    import shutil

    import torch

    native_lib()
    workdir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                           "ingest_smoke")
    shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(workdir)
    st, plan, rij, freqlist = monitor_inputs(MONITOR_HOURS)
    recs, dec, _, (nbytes, nrec, t_enc, t_dec) = ingest_records(st, workdir)
    log(f"[{label}] ingest decode (read_mseed_records, C++, mean of 3): "
        f"{t_dec * 1e3:.2f} ms for {nbytes} B = {nbytes / t_dec / 1e6:.1f} MB/s, "
        f"{nrec / t_dec:.0f} records/s, {dec.nchans * dec.npts / t_dec / 1e6:.1f} "
        f"Msamples/s; encode (write_mseed) {t_enc * 1e3:.2f} ms")
    feed = arrival_order(recs)
    nseg = dec.npts // plan.npts
    nbatches = -(-nseg // MONITOR_DISPATCH)
    for method in ("mxu", "fused"):
        mon, mrecs, segs, ing, t_feed, t_emit, t_all, counts, codecs = ingest_feed(
            dec, plan, rij, freqlist, feed, workdir, method, method)
        check_ingest_segments(method, segs, ing, dec, plan)
        ref = process_whole(dec, plan, rij, freqlist, workdir, method)
        check_ingest_against_process(method, mrecs, ref[0], exact=method == "fused")
        check_monitor_cpu("ingest " + method, dec, plan, rij, mrecs, method)
        res = mon.read_all()
        ground_truth(res, res[4], label=f"ingest {method} ")
        check_monitor_launches("ingest " + method, counts, method, nbatches)
        check_ingest_codec(method, mon, mrecs, codecs)
        log(f"[{label}] ingest {method}: {len(feed)} records in packets of "
            f"{INGEST_PACKET}; feed {t_feed / nseg * 1e3:.3f} ms and emission "
            f"{t_emit / nseg * 1e3:.3f} ms per segment; ingest to the last persisted "
            f"file {t_all:.4f} s = {nseg / t_all:.2f} segments/s, process() of the "
            f"decoded stream {ref[1]:.2f} segments/s; launches icorr_peak fp32 "
            f"{counts[0]} / tensor-core {counts[1]}, fused_xcorr_bucket fp32 "
            f"{counts[2]} / tensor-core {counts[3]}; no retry")
        if method == "mxu":
            persist_times(label, mon, dec, plan, mrecs[0])
    torch.cuda.synchronize()
    shutil.rmtree(workdir, ignore_errors=True)


def process_whole(st, plan, rij, freqlist, workdir, method):
    """process() of the whole stream by a fresh monitor on the card (after
    the ingest run: the kernels are warm); returns (records, segments/s)."""
    import shutil

    import torch
    from narrow_band_least_squares_tpu_torch.models import StreamingMonitor

    d = os.path.join(workdir, method + "-process")
    shutil.rmtree(d, ignore_errors=True)
    mon = StreamingMonitor(plan, rij, d, freqlist, dispatch_segments=MONITOR_DISPATCH,
                           device="cuda", xcorr_method=method)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    recs = mon.process(st)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    mon.close()
    return recs, len(recs) / secs


# --------------------------------------------------------------------------
# golden: the recorded-event fixture through the port's acquisition
# --------------------------------------------------------------------------

def golden_fetch(url, timeout=60.0):
    """tests/data's fixture served by URL, as an FDSN service would."""
    data = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "data")
    name = ("i53_synth_event.mseed" if "dataselect" in url else
            "i53_synth_event.xml" if "level=response" in url else
            "i53_synth_event.txt")
    with open(os.path.join(data, name), "rb") as f:
        return f.read()


def golden_inputs():
    """tests/data's fixture metadata, golden.json, and the golden plan's
    freqlist, band count and window lengths."""
    from narrow_band_least_squares_tpu_torch import api

    data = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "data")
    with open(os.path.join(data, "i53_synth_event_meta.json")) as f:
        meta = json.load(f)
    with open(os.path.join(data, "golden.json")) as f:
        golden = json.load(f)
    freqlist, nbands, _ = api.get_freqlist(GOLDEN_FMIN, GOLDEN_FMAX, "log", GOLDEN_NBANDS)
    winlens = api.get_winlenlist("adaptive", nbands, 20, GOLDEN_WINLEN_1, GOLDEN_WINLEN_X)
    return meta, golden, freqlist, nbands, winlens


def check_golden(out, ncl, golden, label):
    """Per band of ``out`` = (vel, baz, mdccm, ...): the window count, the
    confident-window count (up to windows within GOLDEN_EDGE of the
    threshold) and the medians of baz, vel and MdCCM over confident windows
    (GOLDEN_RTOL) as golden.json has them."""
    mdccm = out[2]
    for b, want in enumerate(golden["bands"]):
        n = ncl[b]
        edge = np.abs(mdccm[b, :n] - GOLDEN_THRESH) <= GOLDEN_EDGE
        good = mdccm[b, :n] > GOLDEN_THRESH
        if n != want["n_windows"]:
            fail(f"{label} band {b}: {n} windows, golden.json {want['n_windows']}")
        if abs(int(good.sum()) - want["n_good"]) > int(edge.sum()):
            fail(f"{label} band {b}: {int(good.sum())} confident windows, golden.json "
                 f"{want['n_good']} ({int(edge.sum())} within {GOLDEN_EDGE} of the "
                 f"threshold)")
        for key, col in (("median_baz", 1), ("median_vel", 0), ("median_mdccm", 2)):
            got = float(np.median(out[col][b, :n][good]))
            if abs(got - want[key]) > GOLDEN_RTOL * abs(want[key]):
                fail(f"{label} band {b} {key}: {got} on the card, golden.json "
                     f"{want[key]} (rtol {GOLDEN_RTOL})")


def phase_golden(label):
    """gather_waveforms_fdsn(..., remove_response=True) on the fixture, then
    api.narrow_band_least_squares on the card at ALPHA 1.0 and 0.75, held
    to tests/data/golden.json (as tests/test_torch_golden.py holds the CPU)
    and to the port on the CPU."""
    from narrow_band_least_squares_tpu_torch import api
    from narrow_band_least_squares_tpu_torch.io.fdsn import gather_waveforms_fdsn

    native_lib()
    meta, golden, freqlist, nbands, winlens = golden_inputs()
    t0 = meta["start_epoch"]
    st = gather_waveforms_fdsn("IRIS", "IM", "I53H*", "", "BDF", t0,
                               t0 + meta["duration_s"], remove_response=True,
                               _fetch=golden_fetch)
    if st.nchans != meta["nchans"] or not np.isfinite(st.data).all():
        fail(f"golden: {st.nchans} channels gathered, not {meta['nchans']}, or "
             f"non-finite samples")
    fr = np.logspace(-2, np.log10(st.fs / 2), 50)

    def run(alpha, device):
        return api.narrow_band_least_squares(
            winlens, 0.5, alpha, st, st.latitudes, st.longitudes, nbands, None, None,
            freqlist, "log", fr, "cheby1", 2, 0.01, device=device)

    from narrow_band_least_squares_tpu_torch.utils import make_plan

    nbuckets = lag_searches(make_plan(freqlist, "log", winlens, 0.5, st.npts, st.fs), st)
    runs = {}
    for alpha in (1.0, 0.75):
        for device in ("cuda", "cpu"):
            first_call()
            with LtsRecorder() as rec:
                zero_launches()
                runs[alpha, device] = run(alpha, device), rec.taus
                counts = lag_search_launches()
            if device == "cuda":
                log(f"golden ALPHA {alpha} on the card: launches icorr_peak fp32 "
                    f"{counts[0]} / tensor-core {counts[1]}, fused_xcorr_bucket "
                    f"{counts[2] + counts[3]} ({nbuckets} window-length buckets)")
                if counts != (0, nbuckets, 0, 0):
                    fail(f"golden at ALPHA {alpha}: launches {counts}, not one "
                         f"icorr_peak tensor-core launch per bucket")
    gpu, cpu = runs[1.0, "cuda"][0], runs[1.0, "cpu"][0]
    ncl = gpu[6]
    check_shapes(gpu, ncl, nbands)
    compare_outputs(gpu, cpu, ncl, label="golden OLS")
    (lg, tau_g), (lc, tau_c) = runs[0.75, "cuda"], runs[0.75, "cpu"]
    compare_lts(lg, lc, tau_g[0], tau_c[0], ncl, "golden LTS")
    check_golden(gpu, ncl, golden, "golden")
    flagged = sum(1 for k in lg[4] if k != "size")
    if flagged != golden["lts_flagged_windows"]:
        fail(f"golden LTS: {flagged} windows in the stdict, golden.json "
             f"{golden['lts_flagged_windows']}")
    check_outlier(lg[4], meta["nchans"], meta["outlier_channel"], "golden LTS")
    log(f"golden: {sum(ncl)} windows in {nbands} bands, counts and the LTS stdict "
        f"({flagged} windows) as golden.json, per-band medians within "
        f"{GOLDEN_RTOL} relative, the card against the CPU as above")


# --------------------------------------------------------------------------
# cli: the port's command line on the card
# --------------------------------------------------------------------------

def cli(*argv):
    """``python -m narrow_band_least_squares_tpu_torch *argv`` in this
    process (so that its launches are counted); returns the JSON it
    printed."""
    import contextlib
    import io

    from narrow_band_least_squares_tpu_torch.__main__ import main as cli_main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli_main([str(a) for a in argv])
    return json.loads(buf.getvalue())


def cli_counted(expect, label, *argv):
    """One command, with every launch count set to 0 just before it and
    read just after; fails unless they are ``expect``.  Returns (the JSON
    it printed, the launches, its seconds)."""
    out = []
    zero_launches()
    secs = wall_s(lambda: out.append(cli(*argv)))
    counts = lag_search_launches()
    if counts != expect:
        fail(f"cli {label}: launches {counts} (icorr_peak fp32, tensor-core, "
             f"fused_xcorr_bucket fp32, tensor-core), not {expect}")
    return out[0], counts, secs


def lag_searches(plan, st, **kw):
    """Window-length buckets of ``plan`` on ``st``'s array: one lag-search
    launch each."""
    from narrow_band_least_squares_tpu_torch.models import NarrowBandPipeline
    from narrow_band_least_squares_tpu_torch.utils import get_rij

    rij = get_rij(st.latitudes, st.longitudes, st.nchans)
    return len(NarrowBandPipeline(plan, rij, device="cpu", **kw)._buckets)


def cfg_plan(st, cfg):
    """The narrow-band plan `run` builds from ``cfg`` for ``st``."""
    from narrow_band_least_squares_tpu_torch import api
    from narrow_band_least_squares_tpu_torch.utils import make_plan

    freqlist, nbands, _ = api.get_freqlist(cfg.FMIN, cfg.FMAX, cfg.FREQ_BAND_TYPE,
                                           cfg.NBANDS)
    winlens = api.get_winlenlist(cfg.WINDOW_LENGTH_TYPE, nbands, cfg.WINLEN,
                                 cfg.WINLEN_1, cfg.WINLEN_X)
    return make_plan(freqlist, cfg.FREQ_BAND_TYPE, winlens, cfg.WINOVER, st.npts, st.fs)


def run_lag_searches(st, cfg):
    """(narrow-band, broadband) lag-search launches of `run` with ``cfg`` on
    ``st``: api.narrow_band_least_squares, then api.ltsva (one band, no
    filter bank)."""
    from narrow_band_least_squares_tpu_torch.utils import make_plan

    broadband = make_plan([0.0, st.fs / 2], "linear", [cfg.WINLEN], cfg.WINOVER,
                          st.npts, st.fs)
    return (lag_searches(cfg_plan(st, cfg), st),
            lag_searches(broadband, st, apply_filter=False))


def run_results(out):
    """(vel, baz, mdccm, t, num_compute_list) of `run`'s TSV in ``out``,
    read back by the port's read_txtfile."""
    from narrow_band_least_squares_tpu_torch.io import read_txtfile

    vel, baz, mdccm, t, _, ncl, _, _, _ = read_txtfile(out, "narrow_band_results")
    return vel, baz, mdccm, t, [int(n) for n in ncl]


def construction_split(label, st, cfg):
    """`run`'s narrow-band phase in two parts: building the pipeline (a
    `run` builds it anew: set_performance_defaults clears the API's cache)
    and running it, each to a synchronize."""
    from narrow_band_least_squares_tpu_torch.models import NarrowBandPipeline
    from narrow_band_least_squares_tpu_torch.utils import get_rij

    plan = cfg_plan(st, cfg)
    rij = get_rij(st.latitudes, st.longitudes, st.nchans)
    fr = np.logspace(-2, np.log10(st.fs / 2), 1000)
    pipe = []
    t_build = wall_s(lambda: pipe.append(NarrowBandPipeline(plan, rij, device="cuda")))
    t_run = wall_s(lambda: pipe[0].run(st, freq_resp_list=fr))
    log(f"[{label}] cli run's narrow-band phase in parts: NarrowBandPipeline(...) "
        f"{t_build:.4f} s (host filter bank and DFT tables, the tables' prepare on the "
        f"card), then pipe.run {t_run:.4f} s")


def cli_canonical(label, workdir, figures):
    """`run --synthetic` with the default config on the card, against the
    same command on the CPU and the truth; launches, config_used.json, the
    figures, and the phase times of a cold and a warm (profiled) run."""
    from narrow_band_least_squares_tpu_torch.config import NBLSConfig
    from narrow_band_least_squares_tpu_torch.io import synthetic_plane_wave
    from narrow_band_least_squares_tpu_torch.utils import profiling
    from narrow_band_least_squares_tpu_torch.utils.timeutils import parse_utc

    cfg = NBLSConfig()
    st = synthetic_plane_wave(   # the stream `run --synthetic` makes
        nchans=8, duration_s=max(parse_utc(cfg.END) - parse_utc(cfg.START), 600.0),
        fs=20.0, baz_deg=230.0, trace_vel_kms=0.34, start_epoch=parse_utc(cfg.START),
        seed=42)
    nb, bb = run_lag_searches(st, cfg)
    expect = (0, nb + bb, 0, 0)
    gdir, cdir, wdir = (os.path.join(workdir, n) for n in ("run-cuda", "run-cpu", "run-warm"))
    flag = [] if figures else ["--no-figures"]
    s_gpu, counts, secs = cli_counted(expect, "run", "run", "--synthetic", "--device", "cuda",
                                      "--out", gdir, *flag)
    log(f"[{label}] cli run --synthetic --device cuda {' '.join(flag)}(the first run "
        f"of this plan in the process): {secs:.4f} s; launches icorr_peak fp32 "
        f"{counts[0]} / tensor-core {counts[1]} = {nb} narrow-band buckets + {bb} "
        f"broadband (ltsva) bucket, fused_xcorr_bucket {counts[2] + counts[3]}; "
        f"PhaseTimers " + json.dumps(s_gpu["phases"]))
    s_cpu, _, secs_cpu = cli_counted((0, 0, 0, 0), "run --device cpu", "run", "--synthetic",
                                     "--device", "cpu", "--no-figures", "--out", cdir)
    warm = []
    busy, rows = device_profile(lambda: warm.append(cli_counted(
        expect, "run (warm)", "run", "--synthetic", "--device", "cuda", "--no-figures",
        "--out", wdir)))
    s_warm, _, secs_warm = warm[0]
    log(f"[{label}] cli run --synthetic --device cuda --no-figures again (warm), under "
        f"the profiler: {secs_warm:.4f} s, device busy {busy:.4f} s "
        f"({100 * busy / secs_warm:.1f}%) in {sum(r[2] for r in rows)} kernels and "
        f"copies; PhaseTimers " + json.dumps(s_warm["phases"]) +
        f"; the same command with --device cpu took {secs_cpu:.4f} s")
    construction_split(label, st, cfg)
    gpu, cpu = run_results(gdir), run_results(cdir)
    if not (gpu[4] == cpu[4] == run_results(wdir)[4] == s_gpu["num_compute_list"]
            == s_cpu["num_compute_list"]):
        fail(f"cli run: num_compute_list {gpu[4]} on the card, {cpu[4]} on the CPU")
    compare_outputs(gpu, cpu, gpu[4], label="cli run")
    ground_truth(gpu, gpu[4], label="cli run ")
    dbaz = (s_gpu["median_baz_deg"] - BAZ_TRUE + 180.0) % 360.0 - 180.0
    if abs(dbaz) > 3.0 or abs(s_gpu["median_vel_kms"] - VEL_TRUE) > 0.1 * VEL_TRUE:
        fail(f"cli run: median baz {s_gpu['median_baz_deg']} and vel "
             f"{s_gpu['median_vel_kms']}, truth {BAZ_TRUE} and {VEL_TRUE}")
    with open(os.path.join(gdir, "config_used.json")) as f:
        if json.load(f) != cfg.to_dict():
            fail("cli run: config_used.json is not NBLSConfig().to_dict()")
    if figures:
        paths = [os.path.join(gdir, n + cfg.file_type) for n in CLI_FIGURES]
        sizes = [os.path.getsize(p) if os.path.exists(p) else 0 for p in paths]
        if not all(sizes):
            fail(f"cli run: figure files missing or empty: {dict(zip(CLI_FIGURES, sizes))}")
        log(f"cli run: {len(paths)} figures at {cfg.dpi_num} dpi, bytes "
            + json.dumps(dict(zip(CLI_FIGURES, sizes))))
    log(f"cli run: the card's TSV as the CPU's, num_compute_list {gpu[4]} on both, "
        f"median baz {s_gpu['median_baz_deg']:.4f} deg, vel {s_gpu['median_vel_kms']:.5f} "
        f"km/s, config_used.json = NBLSConfig().to_dict()")
    log(f"[{label}] cli run summary: " + profiling.RunSummary(
        workload="cli run --synthetic", nbands=s_gpu["bands"],
        num_compute_list=s_gpu["num_compute_list"], nchans=st.nchans, alpha=cfg.ALPHA,
        device=profiling.device_name("cuda"), wall_s=secs,
        phases=s_gpu["phases"]).to_json())


def same_files(a, b, label):
    """Every .npz and .txt of directory ``b`` is in ``a``, arrays and bytes
    equal."""
    names = sorted(n for n in os.listdir(b) if n.endswith((".npz", ".txt")))
    if sorted(n for n in os.listdir(a) if n.endswith((".npz", ".txt"))) != names:
        fail(f"{label}: the files differ: {sorted(os.listdir(a))[:4]}.. against "
             f"{names[:4]}..")
    for n in names:
        pa, pb = os.path.join(a, n), os.path.join(b, n)
        if n.endswith(".txt"):
            with open(pa, "rb") as f, open(pb, "rb") as g:
                same = f.read() == g.read()
        else:
            with np.load(pa) as za, np.load(pb) as zb:
                same = sorted(za.files) == sorted(zb.files) and all(
                    np.array_equal(za[k], zb[k], equal_nan=za[k].dtype.kind == "f")
                    for k in za.files)
        if not same:
            fail(f"{label}: {n} differs")
    return len(names)


def cli_monitor(label, workdir):
    """`monitor` on the monitor's 6 h stream as Steim1 miniSEED, with the
    default config ('mxu') and with a config file that sets 'fused': every
    segment bit for bit StreamingMonitor.process() of the decoded stream,
    the route's launches once per bucket of each batch, and resume."""
    from narrow_band_least_squares_tpu_torch.config import NBLSConfig

    st, plan, rij, freqlist = monitor_inputs(MONITOR_HOURS)
    _, dec, _, _ = ingest_records(st, workdir)
    mseed = os.path.join(workdir, "monitor.mseed")
    coords = os.path.join(workdir, "coords.json")
    with open(coords, "w") as f:
        json.dump({sid: [lat, lon] for sid, lat, lon in
                   zip(dec.ids, dec.latitudes, dec.longitudes)}, f)
    fused_cfg = os.path.join(workdir, "fused.json")
    NBLSConfig(xcorr_method="fused").to_json(fused_cfg)
    nseg = dec.npts // plan.npts
    want = -(-nseg // MONITOR_DISPATCH) * CANONICAL_BUCKETS
    for method in ("mxu", "fused"):
        out = os.path.join(workdir, "cli-" + method)
        argv = ["monitor", "--data", mseed, "--coords", coords, "--segment-s",
                MONITOR_SEGMENT_S, "--dispatch-segments", MONITOR_DISPATCH, "--device",
                "cuda", "--out", out] + ([] if method == "mxu" else ["--config", fused_cfg])
        expect = (0, want, 0, 0) if method == "mxu" else (0, 0, 0, want)
        rep, counts, secs = cli_counted(expect, f"monitor {method}", *argv)
        if rep["segments_processed"] != nseg:
            fail(f"cli monitor {method}: {rep['segments_processed']} segments, not {nseg}")
        process_whole(dec, plan, rij, freqlist, workdir, method)
        nfiles = same_files(out, os.path.join(workdir, method + "-process"),
                            f"cli monitor {method} against process()")
        again, _, secs2 = cli_counted((0, 0, 0, 0), f"monitor {method} again", *argv)
        if again["segments_processed"] != 0:
            fail(f"cli monitor {method}: a second invocation processed "
                 f"{again['segments_processed']} segments, not 0")
        log(f"[{label}] cli monitor ({method}) --data monitor.mseed --segment-s "
            f"{MONITOR_SEGMENT_S:g} --dispatch-segments {MONITOR_DISPATCH}: {nseg} "
            f"segments in {secs:.4f} s (miniSEED decode included), {nfiles} files bit "
            f"for bit StreamingMonitor.process() of the decoded stream; launches "
            f"icorr_peak fp32 {counts[0]} / tensor-core {counts[1]}, fused_xcorr_bucket "
            f"fp32 {counts[2]} / tensor-core {counts[3]}; again: 0 segments in "
            f"{secs2:.4f} s (resume)")


class offline_fdsn:
    """While installed (``with``): ``urllib.request.urlopen`` serves
    tests/data's fixture (`golden_fetch`) and ObsPy cannot be imported, as
    tests/test_torch_fdsn.py's fake does, so that `fetch` reaches no
    network."""

    class Response:
        def __init__(self, data):
            self.data = data

        def read(self):
            return self.data

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    def __enter__(self):
        import urllib.request

        self.real = urllib.request.urlopen
        self.obspy = sys.modules.get("obspy", self)
        urllib.request.urlopen = lambda req, timeout=0: self.Response(
            golden_fetch(getattr(req, "full_url", req)))
        sys.modules["obspy"] = None
        return self

    def __exit__(self, *exc):
        import urllib.request

        urllib.request.urlopen = self.real
        if self.obspy is self:
            del sys.modules["obspy"]
        else:
            sys.modules["obspy"] = self.obspy


def cli_fetch_run(label, workdir):
    """`fetch` of the golden fixture, then `run --data` on its npz with the
    golden plan, held to golden.json."""
    import datetime

    from narrow_band_least_squares_tpu_torch.config import NBLSConfig
    from narrow_band_least_squares_tpu_torch.io import ArrayStream

    meta, golden, _, _, _ = golden_inputs()

    def iso(epoch):
        return datetime.datetime.fromtimestamp(epoch, datetime.timezone.utc).strftime(
            "%Y-%m-%dT%H:%M:%S")

    cfg = NBLSConfig(START=iso(meta["start_epoch"]),
                     END=iso(meta["start_epoch"] + meta["duration_s"]),
                     FMIN=GOLDEN_FMIN, FMAX=GOLDEN_FMAX, NBANDS=GOLDEN_NBANDS, WINLEN=20,
                     WINLEN_1=GOLDEN_WINLEN_1, WINLEN_X=GOLDEN_WINLEN_X, ALPHA=1.0)
    cpath, npz = os.path.join(workdir, "golden.json"), os.path.join(workdir, "event.npz")
    cfg.to_json(cpath)
    with offline_fdsn():
        rep, _, t_fetch = cli_counted((0, 0, 0, 0), "fetch", "fetch", "--config", cpath,
                                      "--out", npz)
    st = ArrayStream.load_npz(npz)
    if (rep["nchans"], rep["npts"]) != (meta["nchans"], st.npts) or \
            not np.isfinite(st.data).all():
        fail(f"cli fetch: {rep}")
    nb, bb = run_lag_searches(st, cfg)
    out = os.path.join(workdir, "golden-run")
    s, counts, secs = cli_counted((0, nb + bb, 0, 0), "run on the fetched event", "run",
                                  "--data", npz, "--config", cpath, "--device", "cuda",
                                  "--no-figures", "--out", out)
    res = run_results(out)
    if res[4] != s["num_compute_list"]:
        fail(f"cli fetch+run: the TSV's num_compute_list {res[4]}, the summary's "
             f"{s['num_compute_list']}")
    check_golden(res, res[4], golden, "cli fetch+run")
    log(f"[{label}] cli fetch (golden fixture, served offline, response removed): "
        f"{rep['nchans']} x {rep['npts']} samples in {t_fetch:.4f} s; run --data "
        f"event.npz on the card: {secs:.4f} s, launches icorr_peak tensor-core "
        f"{counts[1]} = {nb} + {bb} buckets; {sum(res[4])} windows in "
        f"{len(res[4])} bands as golden.json (counts, medians within {GOLDEN_RTOL})")


def phase_cli(label):
    """The port's command line on the card: `run`, `monitor`, `fetch`."""
    import importlib.util
    import shutil

    workdir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                           "cli_smoke")
    shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(workdir)
    native_lib()
    figures = importlib.util.find_spec("matplotlib") is not None
    if not figures:
        log("cli: matplotlib is not installed on this machine, so `run` draws no "
            "figures here (--no-figures); the CPU tests hold the figures")
    cli_canonical(label, workdir, figures)
    cli_monitor(label, workdir)
    cli_fetch_run(label, workdir)
    shutil.rmtree(workdir, ignore_errors=True)


# --------------------------------------------------------------------------
# the last options: sub-sample delays, patches, dtypes, sosfilt, the oracle
# --------------------------------------------------------------------------

# the neighbour route's (cm, cp) against the float64 sums of the products
# its precision takes at idx -/+ 1 (`own_value`), relative to the largest
# |peak|, as the peak is held (KERNEL_RTOL; DEFAULT_RTOL at 'default')
NB_EDGE_NLAG = 300         # three lag tiles of 128: 0-127, 128-255, 256-299
NB_EDGE_DOMINANT = (0, 127, 128, 255, 256, 299)
# per block of 192 rows (one tensor-core CTA, three fp32 CTAs): [lo, hi]
# and the lag that must win; -1: a random range with no dominant column
NB_EDGE_BLOCKS = ((0, 50, 0),        # lo = 0: cm is the placeholder 0
                  (100, 127, 127),   # last column of tile 0: cp from tile 1
                  (128, 200, 128),   # lo on a boundary, tile 0 searched by no row
                  (200, 255, 255),   # hi on a boundary, tile 2 searched by no row
                  (256, 290, 256),   # first column of the last tile
                  (260, 299, 299),   # hi = nlag - 1: cp is the placeholder 0
                  (129, 254, -1),    # inside tile 1
                  (1, 298, -1))      # across all tiles
# the bfloat16 ltsva (canonical data, 0.5-2 Hz, 30 s windows) on the card
# against the CPU's: measured on an H100 (700 W) equal in vel and baz on
# all 79 windows and within 6.6e-7 in MdCCM (float32, from bf16 energies
# summed in another order), once every product with a host scalar is taken
# in float32 (`ops.xcorr.lag_seconds`, `ops.solve.degrees`: CUDA rounds
# the scalar to bf16, the CPU does not).  The limits allow one bf16 step of
# vel (2^-8 of itself) and of baz (1 degree above 128), and 1e-5 of MdCCM.
# Against float32 it is logged only: the JAX step rounds the lag index
# itself to bfloat16 (idx.astype(dtype)), so delays past 256 lags move in
# steps of 2 to 8 samples.
BF16_VEL_RTOL = 2.0 ** -8
BF16_BAZ_DEG = 1.0
BF16_MDCCM_ATOL = 1e-5
# The recurrence's loop-carried chain in csrc/sosfilt.cu, a sample and a
# section: z1 -> ys = fma(b0, y, z1) -> a1 ys (multiply) -> fma(b1, y,
# -(a1 ys)) -> + z2 (add) -> z1: four dependent float operations, as before
# the kernel took the JAX package's contractions (an add, a multiply, a
# subtract and an add): the fused multiply-adds take off the path only the
# products with y, which never were on it.
SOSFILT_CHAIN_OPS = 4
# Cycles of one dependent FP32 add or multiply on an SM: the latency that
# microbenchmark studies report for Volta through Hopper (an assumption of
# the bound, not measured here).
FP32_LATENCY_CYCLES = 4
SOSFILT_RTOL = 1e-3        # tests/test_jax_pipeline.py:231, against scipy in float64
# the canonical runs against the port's NumPy oracle (tests/test_jax_pipeline.py)
ORACLE_MDCCM_ATOL = 1e-2
ORACLE_BAZ_Q90_DEG = 1.0
ORACLE_VEL_MEDIAN = 1e-2
ORACLE_LTS_FLAGS_MIN = 0.75
ORACLE_LTS_BAZ_Q75_DEG = 2.0


def nb_edge_case(K2p=256, seed=8):
    """Small random e2 with dominant columns at NB_EDGE_DOMINANT and
    non-negative cs2, rows in blocks of 192 with the ranges of
    NB_EDGE_BLOCKS: peaks on the first and last column of a tile, next to
    a tile that no row of the block searches, at lag 0 and nlag - 1."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    R = 192 * len(NB_EDGE_BLOCKS)
    cs2 = torch.rand(R, K2p, generator=g, device="cuda")
    e2 = 0.1 * torch.randn(K2p, NB_EDGE_NLAG, generator=g, device="cuda")
    for d in NB_EDGE_DOMINANT:
        e2[:, d] = 1.0 + 0.5 * torch.rand(K2p, generator=g, device="cuda")
    lo = torch.empty(R, dtype=torch.int32, device="cuda")
    hi = torch.empty_like(lo)
    want = torch.full_like(lo, -1)
    for k, (l, h, w) in enumerate(NB_EDGE_BLOCKS):
        rows = slice(192 * k, 192 * (k + 1))
        lo[rows], hi[rows], want[rows] = l, h, w
    return cs2, e2, lo, hi, want


def check_icorr_nb(name, cs2, e2, lo, hi, precision, want=None):
    """The neighbour route at ``precision``: (peak, idx) bit for bit the
    integer route's on the same inputs; (cm, cp) within rtol * max|peak| of
    the float64 sums of the route's own products at idx -/+ 1, exactly 0
    where idx is 0 or nlag - 1, and within the same of the plain version
    on rows where its idx is the kernel's.  Returns max |cm, cp error|
    against the plain version."""
    import torch
    from narrow_band_least_squares_tpu_torch.ops.kernels import xcorr_peak as XP

    rtol = DEFAULT_RTOL if precision == "default" else KERNEL_RTOL
    prep = XP.prepare(e2, precision)
    before = (XP.launches_nb, XP.launches_nb_tc)
    pk, ix, cm, cp = XP.icorr_peak(cs2, e2, lo, hi, precision=precision,
                                   prepared=prep, neighbours=True)
    tc = precision != "highest"
    if (XP.launches_nb - before[0], XP.launches_nb_tc - before[1]) != (int(not tc), int(tc)):
        fail(f"icorr_peak neighbours {name} ({precision}) took the wrong route")
    pk0, ix0 = XP.icorr_peak(cs2, e2, lo, hi, precision=precision, prepared=prep)
    pr, ir, cmr, cpr = XP.icorr_peak_reference(cs2, e2, lo, hi, precision=precision,
                                               neighbours=True)
    torch.cuda.synchronize()
    tag = f"icorr_peak neighbours {name} [{precision}]"
    if not (torch.equal(pk, pk0) and torch.equal(ix, ix0)):
        fail(f"{tag}: (peak, idx) differ from the integer route's bits on "
             f"{int(((pk != pk0) | (ix != ix0)).sum())} rows")
    if want is not None:
        forced = want >= 0
        if not torch.equal(ix[forced], want[forced]):
            fail(f"{tag}: {int((ix[forced] != want[forced]).sum())} rows missed "
                 f"their dominant lag")
    nlag = e2.shape[1]
    fin = torch.isfinite(pk)
    scale = float(pk[fin].abs().max())
    errs = []
    for side, got, ref, k, edge in (("cm", cm, cmr, ix - 1, ix == 0),
                                    ("cp", cp, cpr, ix + 1, ix == nlag - 1)):
        if bool((got[edge & fin] != 0).any()):
            fail(f"{tag}: {side} is not the placeholder 0 at the table's edge")
        rows = (fin & ~edge).nonzero().flatten()
        own = own_value(cs2, e2, rows, k[rows].long(), precision)
        d_own = (got[rows].double() - own).abs()
        if bool((d_own > rtol * scale).any()):
            fail(f"{tag}: {side} differs from the route's own products beyond "
                 f"rtol {rtol} (max {float(d_own.max()):.3e}, scale {scale:.3e})")
        same = (ix == ir) & fin
        d_ref = (got[same] - ref[same]).abs()
        if bool((d_ref > rtol * scale).any()):
            fail(f"{tag}: {side} differs from the plain version beyond rtol {rtol} "
                 f"(max {float(d_ref.max()):.3e}, scale {scale:.3e})")
        errs.append(float(d_ref.max()) if d_ref.numel() else 0.0)
    moved = int(((ix != ir) & fin).sum())
    at_edge = int(((ix % 128 == 0) | (ix % 128 == 127)).sum())
    log(f"{tag}: R={cs2.shape[0]} K2p={cs2.shape[1]} nlag={nlag}: (peak, idx) "
        f"bit for bit the integer route; max |cm, cp err| against plain "
        f"{max(errs):.3e} (scale {scale:.3e}); {at_edge} rows peak on a tile "
        f"edge; {moved} near-tie rows where the plain version picks another lag")
    return max(errs)


def options_kernel():
    """The neighbour route on the random canonical-sized cases, the tie
    case and the tile-edge case at every precision; returns the largest
    (cm, cp) error against the plain version per precision."""
    cases = {"canonical-largest-K": random_case(1092, 2432, 2399, 1),
             "canonical-largest-R": random_case(2212, 1280, 1199, 2)}
    cs2, e2, lo, hi, want = tie_case()
    cases["tie"] = (cs2, e2, lo, hi, want)
    cases["tile-edge"] = nb_edge_case()
    errs = {}
    for prec in PRECISIONS:
        for name, args in cases.items():
            e = check_icorr_nb(name, *args[:4], precision=prec,
                               want=args[4] if len(args) > 4 else None)
            errs[prec] = max(errs.get(prec, 0.0), e)
    return errs


def subsample_run(plan, rij, st, device, precision):
    """One subsample 'mxu' step on ``device``: (outputs, integer-lag delays
    of the same step, neighbour-route launches (fp32, tensor cores),
    integer-route launches); on the card also (subsample delays, outputs
    with integer lags).  NumPy."""
    import torch
    from narrow_band_least_squares_tpu_torch.models import NarrowBandPipeline
    from narrow_band_least_squares_tpu_torch.ops.kernels import xcorr_peak as XP

    pipe = NarrowBandPipeline(plan, rij, subsample_delays=True,
                              matmul_precision=precision, device=device)
    XP.launches = XP.launches_tc = XP.launches_nb = XP.launches_nb_tc = 0
    out = pipe.run_raw(st.data)
    if device == "cuda":
        torch.cuda.synchronize()
    nb = (XP.launches_nb, XP.launches_nb_tc)
    plain = (XP.launches, XP.launches_tc)
    np_ = lambda d: {k: v.cpu().numpy() for k, v in d.items()}
    y = pipe._filter(pipe._to_device(st.data))
    extra = ()
    if device == "cuda":
        extra = (pipe._delays(y)[0].cpu().numpy(),)
    pipe.subsample_delays = False
    tau_int = pipe._delays(y)[0].cpu().numpy()
    if device == "cuda":
        extra += (np_(pipe.run_raw(st.data)),)
    return (np_(out), tau_int, nb, plain) + extra


def options_subsample(label, st, plan, rij):
    """The canonical plan with subsample_delays=True, 'mxu', at 'high' and
    'highest' (and 'default' against the truth): one neighbour launch per
    bucket and no integer-route launch; card against CPU within TOL on
    every valid window whose integer lags are equal; the truth; the median
    sig_tau against the integer-lag run.  Returns the launches per
    precision."""
    ncl = plan.num_compute_list
    cpu, tint_c, _, _ = subsample_run(plan, rij, st, "cpu", "high")
    launches = {}
    for prec in ("high", "highest", "default"):
        gpu, tint_g, nb, plain, tsub_g, gint = subsample_run(plan, rij, st, "cuda", prec)
        own = nb[0] if prec == "highest" else nb[1]
        if own != CANONICAL_BUCKETS or sum(nb) != own or plain != (0, 0):
            fail(f"subsample at {prec}: neighbour launches {nb} and integer "
                 f"launches {plain}; want {CANONICAL_BUCKETS} on the "
                 f"{'fp32' if prec == 'highest' else 'tensor-core'} neighbour route only")
        launches[prec] = own
        wm = np.zeros(gpu["vel"].shape, dtype=bool)
        for b, n in enumerate(ncl):
            wm[b, :n] = True
        frac = np.abs(tsub_g - tint_g)[wm] * plan.fs
        if prec != "default":
            same = (tint_g == tint_c).all(-1) & wm
            worst = 0.0
            for nm in ("vel", "baz", "mdccm", "sig_tau"):
                g, c = gpu[nm][same], cpu[nm][same]
                d = np.abs((g - c + 180.0) % 360.0 - 180.0) if nm == "baz" else np.abs(g - c)
                lim = TOL + TOL * np.abs(c)
                worst = max(worst, float((d / lim).max()))
                if not (d <= lim).all():
                    fail(f"subsample at {prec}: {nm} differs between cuda and cpu "
                         f"beyond {TOL} on {int((d > lim).sum())} windows with "
                         f"equal integer lags")
            log(f"subsample at {prec} cuda vs cpu: {int(same.sum())}/{int(wm.sum())} "
                f"valid windows with equal integer lags ({int(wm.sum() - same.sum())} "
                f"moved); vel/baz/mdccm/sig_tau within {TOL} on them (worst "
                f"|d|/tol {worst:.3f})")
        conf = (gpu["mdccm"] > MDCCM_THRESH) & wm
        log(f"subsample at {prec}: neighbour launches {own} a step; |frac| "
            f"median {np.median(frac):.4f}, max {frac.max():.4f} samples; median "
            f"sig_tau on confident windows {np.median(gpu['sig_tau'][conf]):.6f} s "
            f"against {np.median(gint['sig_tau'][conf]):.6f} s with integer lags; "
            f"max |vel| change {np.abs(gpu['vel'] - gint['vel'])[wm].max():.3e} km/s")
        ground_truth((gpu["vel"], gpu["baz"], gpu["mdccm"]), ncl,
                     label=f"subsample {prec} ")
    return launches


def options_patches_dtypes(st, plan, rij):
    """'patches' bit for bit 'gather' with bucketing off, float64 bit for
    bit float32, on the card; the bfloat16 ltsva against float32 and the
    CPU's bfloat16."""
    import torch
    from narrow_band_least_squares_tpu_torch import api
    from narrow_band_least_squares_tpu_torch.io.stream import ArrayStream
    from narrow_band_least_squares_tpu_torch.models import NarrowBandPipeline
    from narrow_band_least_squares_tpu_torch.oracle import filter_and_taper

    def run(**kw):
        pipe = NarrowBandPipeline(plan, rij, device="cuda", **kw)
        return {k: v.cpu() for k, v in pipe.run_raw(st.data).items()}

    pat = run(window_method="patches", bucket_bands=True)
    gat = run(window_method="gather", bucket_bands=False)
    for k in gat:
        if not torch.equal(pat[k], gat[k]):
            fail(f"patches: {k} differs from gather (bucketing off) on the card")
    f64, f32 = run(dtype=torch.float64), run()
    for k in f32:
        if f64[k].dtype != torch.float32 or not torch.equal(f64[k], f32[k]):
            fail(f"dtype float64: {k} differs from float32 on the card")
    log("patches (bucketing off, as in the JAX package) bit for bit gather on "
        "the card; dtype=float64 computes float32, bit for bit float32")

    filt, _ = filter_and_taper(st.data, st.fs, "cheby1", 0.5, 2.0, 2, 0.01)
    stf = ArrayStream(data=filt, fs=st.fs, start_epoch=st.start_epoch, ids=list(st.ids),
                      latitudes=st.latitudes, longitudes=st.longitudes)
    out = {}
    for key, dev, dt in (("bf16", "cuda", torch.bfloat16), ("f32", "cuda", None),
                         ("bf16-cpu", "cpu", torch.bfloat16)):
        prev = api.set_performance_defaults(dtype=dt)
        try:
            out[key] = api.ltsva(stf, st.latitudes, st.longitudes, 30.0, WINOVER,
                                 1.0, device=dev)
        finally:
            api.set_performance_defaults(dtype=None)
            api.set_performance_defaults(**prev)
    b, f, c = out["bf16"], out["f32"], out["bf16-cpu"]
    conf = c[3] > MDCCM_THRESH
    for ref, what, held in ((c, "bfloat16 on the CPU", True),
                            (f, "float32 on the card", False)):
        dv = np.abs(b[0] - ref[0]) / np.abs(ref[0])
        db = np.abs((b[1] - ref[1] + 180.0) % 360.0 - 180.0)
        dm = np.abs(b[3] - ref[3])
        log(f"bf16 ltsva against {what}: {len(b[0])} windows ({int(conf.sum())} "
            f"confident, {int((dv[conf] > 2.0 ** -8).sum())} of them with vel "
            f"off by more than a bf16 step): max |vel| rel {np.nanmax(dv[conf]):.3e}, |baz| "
            f"{np.nanmax(db[conf]):.3f} deg, |MdCCM| {dm.max():.3e} on them (all "
            f"windows: vel {np.nanmax(dv):.3e}, baz {np.nanmax(db):.3f})")
        if held and ((dv[conf] > BF16_VEL_RTOL).any() or (db[conf] > BF16_BAZ_DEG).any()
                     or (dm > BF16_MDCCM_ATOL).any()):
            fail(f"bf16 ltsva on the card differs from {what} beyond vel "
                 f"{BF16_VEL_RTOL:.3e} rel, baz {BF16_BAZ_DEG} deg (confident "
                 f"windows), MdCCM {BF16_MDCCM_ATOL}")


def options_sosfilt(label, st, plan):
    """filter_stream_scan of each canonical band on the card: the kernel
    against the plain version (CPU, bit for bit) on one band and a
    four-section design, and against scipy's sosfilt in float64 on all;
    timings of one launch.  Returns the kernels-line record."""
    import torch
    from scipy import signal
    from narrow_band_least_squares_tpu_torch.ops import filters as F
    from narrow_band_least_squares_tpu_torch.ops.kernels import sosfilt as SF

    sos_list = [F.design_sos("cheby1", *plan.edges(b), 2, 0.01, st.fs)
                for b in range(plan.nbands)]
    taper = F.taper_window(st.npts, 0.01)
    x = torch.as_tensor(st.data, dtype=torch.float32)
    xd, td = x.cuda(), torch.as_tensor(taper, dtype=torch.float32).cuda()
    sd = [torch.as_tensor(s, dtype=torch.float32).cuda() for s in sos_list]
    SF.launches = 0
    ys = [F.filter_stream_scan(xd, s, td, False) for s in sd]
    torch.cuda.synchronize()
    launches = SF.launches
    if launches != plan.nbands:
        fail(f"sosfilt: {launches} launches for {plan.nbands} bands")
    worst_scipy = 0.0
    for b, (y, sos) in enumerate(zip(ys, sos_list)):
        ref = signal.sosfilt(sos, st.data, axis=-1) * taper
        err = float(np.abs(y.cpu().numpy() - ref).max() / np.abs(ref).max())
        worst_scipy = max(worst_scipy, err)
        if err > SOSFILT_RTOL:
            fail(f"sosfilt band {b}: {err:.3e} of the peak from scipy's float64 "
                 f"sosfilt (limit {SOSFILT_RTOL})")
    plain = SF.sosfilt_reference(sd[0].cpu(), x)
    got = SF.sosfilt(sd[0], xd).cpu()
    max_err = float((got - plain).abs().max())
    if not torch.equal(got, plain):
        fail(f"sosfilt band 0: the kernel differs from its plain version "
             f"(max {max_err:.3e})")
    # a fourth-order design: four sections, another of the kernel's
    # instances, on the first 4,000 samples
    sos4 = torch.as_tensor(F.design_sos("cheby1", *plan.edges(3), 4, 0.01, st.fs),
                           dtype=torch.float32)
    got4 = SF.sosfilt(sos4.cuda(), xd[:, :4000]).cpu()
    if not torch.equal(got4, SF.sosfilt_reference(sos4, x[:, :4000])):
        fail("sosfilt with four sections differs from its plain version")
    N, T = x.shape
    S = sd[0].shape[0]
    kt = device_ms(lambda: SF.sosfilt(sd[0], xd), reps=5)
    t0 = time.perf_counter()
    SF.sosfilt_reference(sd[0], xd)
    torch.cuda.synchronize()
    pt = (time.perf_counter() - t0) * 1e3
    nbytes = 4.0 * (2 * N * T + 6 * S)
    flops = 9.0 * N * T * S
    bound, by = (max(nbytes / PEAK_HBM_BYTES, flops / PEAK_FP32_FLOPS) * 1e3,
                 "bytes" if nbytes / PEAK_HBM_BYTES >= flops / PEAK_FP32_FLOPS
                 else "operations")
    # the rows run in parallel, each a chain of T samples of SOSFILT_CHAIN_OPS
    # dependent operations, at the card's highest SM clock
    clock_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60).stdout.split()[0])
    chain_ms = T * SOSFILT_CHAIN_OPS * FP32_LATENCY_CYCLES / (clock_mhz * 1e6) * 1e3
    log(f"[{label}] sosfilt: {launches} launches ({plan.nbands} bands x {N} rows x "
        f"{T} samples, {S} sections); bit for bit its plain version on band 0 "
        f"and with {sos4.shape[0]} sections; worst {worst_scipy:.3e} of the peak from scipy "
        f"float64; one launch: kernel {kt:.4f} ms, plain (a loop over samples on "
        f"the card) {pt:.1f} ms, bound {bound * 1e3:.3f} us by {by}; the dependent "
        f"chain: {T} samples x {SOSFILT_CHAIN_OPS} operations x {FP32_LATENCY_CYCLES} "
        f"cycles at {clock_mhz:.0f} MHz = {chain_ms:.4f} ms; library: none")
    return {"name": "sosfilt", "route": "cuda", "per": "launch",
            "source": "narrow_band_least_squares_tpu_torch/csrc/sosfilt.cu",
            "replaces": "none: the port's own kernel for "
                        "narrow_band_least_squares_tpu/ops/filters.py:164 (lax.scan)",
            "launches": launches, "max_abs_err": max_err, "ms": kt, "plain_ms": pt,
            "bound_ms": bound, "bound_by": by, "latency_bound_ms": chain_ms,
            "library_ms": None}


def oracle_compare(label, gpu, orc, ncl, lts):
    """Per band, the card's API outputs against the port's float64 oracle at
    tests/test_jax_pipeline.py's tolerances."""
    vel_g, baz_g, md_g, t_g, sd_g, sig_g = gpu[:6]
    vel_o, baz_o, md_o, t_o, sd_o, sig_o, num_o = orc[:7]
    if list(num_o) != list(ncl):
        fail(f"{label}: window counts differ from the oracle's")
    agree = total = 0
    for b, n in enumerate(ncl):
        if not np.allclose(t_g[b, :n], t_o[b, :n], rtol=0, atol=1e-9):
            fail(f"{label} band {b}: window times differ from the oracle's")
        d = np.abs((baz_g[b, :n] - baz_o[b, :n] + 180.0) % 360.0 - 180.0)
        if lts:
            if np.quantile(d, 0.75) >= ORACLE_LTS_BAZ_Q75_DEG:
                fail(f"{label} band {b}: baz 75% quantile off the oracle by "
                     f"{np.quantile(d, 0.75):.3f} deg")
            continue
        if np.abs(md_g[b, :n] - md_o[b, :n]).max() > ORACLE_MDCCM_ATOL:
            fail(f"{label} band {b}: MdCCM off the oracle beyond {ORACLE_MDCCM_ATOL}")
        if np.quantile(d, 0.9) >= ORACLE_BAZ_Q90_DEG:
            fail(f"{label} band {b}: baz 90% quantile off the oracle by "
                 f"{np.quantile(d, 0.9):.3f} deg")
        if np.median(np.abs(vel_g[b, :n] - vel_o[b, :n])) >= ORACLE_VEL_MEDIAN:
            fail(f"{label} band {b}: median |vel| off the oracle beyond "
                 f"{ORACLE_VEL_MEDIAN}")
    if lts:
        keys = sorted(k for k in sd_o if k != "size")
        if keys != sorted(k for k in sd_g if k != "size"):
            fail(f"{label}: the stdict keys differ from the oracle's")
        for k in keys:
            fo = set(map(tuple, np.asarray(sd_o[k]).reshape(-1, 2))) if len(sd_o[k]) else set()
            fg = set(map(tuple, np.asarray(sd_g[k]).reshape(-1, 2))) if len(sd_g[k]) else set()
            agree += len(fo & fg)
            total += max(len(fo), len(fg), 1)
        if agree / total <= ORACLE_LTS_FLAGS_MIN:
            fail(f"{label}: flags agree with the oracle on {agree / total:.3f} of "
                 f"the cells (limit {ORACLE_LTS_FLAGS_MIN})")
    log(f"{label} against the port's NumPy oracle (float64): per band within "
        f"tests/test_jax_pipeline.py's tolerances"
        + (f"; flags agree on {agree}/{total} = {agree / total:.3f} of the cells"
           if lts else ""))


def options_oracle():
    """The canonical OLS run, and LTS with one incoherent element, through
    the API on the card against the port's oracle (FFT correlation, a
    process a band)."""
    from narrow_band_least_squares_tpu_torch.oracle import narrow_band_least_squares_oracle

    fr = np.logspace(-2, np.log10(FS / 2), 100)
    for alpha, outliers in ((1.0, ()), (LTS_ALPHA, (LTS_OUTLIER,))):
        st, freqlist, winlens = canonical_inputs(outlier_channels=outliers)
        gpu = run_api(st, freqlist, winlens, "cuda", alpha=alpha)
        t0 = time.perf_counter()
        orc = narrow_band_least_squares_oracle(
            winlens, WINOVER, alpha, st, st.latitudes, st.longitudes, NBANDS,
            freqlist, "log", fr, "cheby1", 2, 0.01, xcorr_method="fft", n_jobs=NBANDS)
        log(f"oracle at ALPHA {alpha}: {time.perf_counter() - t0:.1f} s on the host")
        oracle_compare(f"canonical ALPHA {alpha}", gpu, orc, gpu[6], alpha < 1.0)


def options_timing(label, plan, rij, st, nb_errs, launches):
    """Per precision, on the canonical subsample step's inputs: the
    neighbour route against the integer route, its plain version and the
    library (SGEMM + mask + max + two gathers); the peak memory of the
    canonical 'mxu' step beside the subsample one.  Returns the records."""
    import torch
    from narrow_band_least_squares_tpu_torch.models import NarrowBandPipeline
    from narrow_band_least_squares_tpu_torch.ops.kernels import xcorr_peak as XP

    pipe = NarrowBandPipeline(plan, rij, subsample_delays=True, device="cuda")
    seen = capture_icorr_inputs(pipe, st.data)
    tot = {p: dict(ms=0.0, int_ms=0.0, plain_ms=0.0, library_ms=0.0, flops=0.0,
                   nbytes=0.0) for p in PRECISIONS}
    for args, _ in seen:
        cs2, e2, lo, hi = args
        nlag = e2.shape[1]
        span = (torch.clamp(hi.long() + 1, max=nlag - 1)
                - torch.clamp(lo.long() - 1, min=0) + 1).clamp(min=0).sum().item()
        f = 2.0 * cs2.shape[1] * span
        b = 4.0 * (cs2.numel() + e2.numel() + lo.numel() + hi.numel() + 4 * cs2.shape[0])
        lib = {False: device_ms(lambda: library_peak_nb(*args), reps=5),
               True: device_ms(lambda: library_peak_nb(*args, tf32=True), reps=5)}
        for prec in PRECISIONS:
            prep = XP.prepare(e2, prec)
            t = tot[prec]
            t["ms"] += device_ms(lambda: XP.icorr_peak(*args, precision=prec, prepared=prep,
                                                       neighbours=True), reps=10)
            t["int_ms"] += device_ms(lambda: XP.icorr_peak(*args, precision=prec,
                                                           prepared=prep), reps=10)
            t["plain_ms"] += device_ms(lambda: XP.icorr_peak_reference(
                *args, precision=prec, neighbours=True), reps=3)
            t["library_ms"] += lib[prec == "default"]
            t["flops"] += f
            t["nbytes"] += b
    recs = []
    for prec in PRECISIONS:
        t = tot[prec]
        t["bound_ms"], t["bound_by"] = route_bound_ms(t["flops"], t["nbytes"], prec)
        log(f"[{label}] icorr_peak neighbour route per canonical step at {prec} "
            f"({len(seen)} launches): kernel {t['ms']:.4f} ms against the integer "
            f"route's {t['int_ms']:.4f} ms (+{100 * (t['ms'] / t['int_ms'] - 1):.1f}%), "
            f"plain {t['plain_ms']:.4f} ms, library "
            f"({'1xTF32' if prec == 'default' else 'fp32'} SGEMM + mask + max + two "
            f"gathers) {t['library_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms by "
            f"{t['bound_by']}")
        recs.append({
            "name": f"icorr_peak_nb@{prec}", "route": "cuda", "precision": prec,
            "source": SOURCES[prec],
            "replaces": "narrow_band_least_squares_tpu/ops/kernels/xcorr_peak.py:94",
            "launches": launches.get(prec, 0), "max_abs_err": nb_errs.get(prec),
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
        })
    pipes = {sub: NarrowBandPipeline(plan, rij, subsample_delays=sub, device="cuda")
             for sub in (False, True)}
    step_ms = {False: [], True: []}
    for sub in (False, True, True, False):       # in turns: the host's load drifts
        p = pipes[sub]
        step_ms[sub].append(cuda_time_ms(lambda: p.run_raw(st.data), reps=20))
    for sub, p in pipes.items():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        p.run_raw(st.data)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        busy, _ = device_profile(lambda: [p.run_raw(st.data) for _ in range(5)])
        log(f"[{label}] canonical 'mxu' step at 'high'"
            + (" with subsample_delays" if sub else "")
            + f": {np.mean(step_ms[sub]):.4f} ms per run_raw step (turns "
            f"{', '.join(f'{v:.4f}' for v in step_ms[sub])}), device busy "
            f"{busy / 5 * 1e3:.4f} ms a step; torch.cuda.max_memory_allocated "
            f"{peak / 2**20:.1f} MiB ({(peak - base) / 2**20:.1f} MiB above the "
            f"{base / 2**20:.1f} MiB held before the step)")
    return recs


def library_peak_nb(cs2, e2, lo, hi, tf32=False):
    """`library_peak` and the two neighbouring correlations gathered from
    the unmasked product."""
    import torch

    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high" if tf32 else "highest")
    try:
        cc = torch.matmul(cs2, e2)
    finally:
        torch.set_float32_matmul_precision(prev)
    col = torch.arange(cc.shape[1], device=cc.device)
    bad = (col[None, :] < lo[:, None]) | (col[None, :] > hi[:, None])
    peak, idx = cc.masked_fill(bad, float("-inf")).max(dim=1)
    n = cc.shape[1] - 1
    cm = cc.gather(1, (idx - 1).clamp(0, n)[:, None])
    cp = cc.gather(1, (idx + 1).clamp(0, n)[:, None])
    return peak, idx, cm, cp


def phase_options(label):
    """The options this slice ports, on the card; returns the kernels-line
    records of the neighbour route and sosfilt."""
    from narrow_band_least_squares_tpu_torch.utils import get_rij, make_plan

    t0 = time.perf_counter()
    lap = lambda what: log(f"options: {what} done at {time.perf_counter() - t0:.1f} s")
    nb_errs = options_kernel()
    lap("kernel checks")
    st, freqlist, winlens = canonical_inputs()
    plan = make_plan(freqlist, "log", winlens, WINOVER, st.npts, st.fs)
    rij = get_rij(st.latitudes, st.longitudes, st.nchans)
    launches = options_subsample(label, st, plan, rij)
    lap("subsample")
    options_patches_dtypes(st, plan, rij)
    lap("patches and dtypes")
    srec = options_sosfilt(label, st, plan)
    lap("sosfilt")
    options_oracle()
    lap("oracle")
    recs = options_timing(label, plan, rij, st, nb_errs, launches)
    lap("timing")
    return recs + [srec]


# --------------------------------------------------------------------------
# timings
# --------------------------------------------------------------------------

def capture_icorr_inputs(pipe, data):
    """Run one step with a recorder around the xcorr module's icorr_peak, and
    return the arguments of every launch, ((cs2, e2, lo, hi), keywords)
    (these launches are not counted as the main path's)."""
    from narrow_band_least_squares_tpu_torch.ops import xcorr as XC

    real, seen = XC.icorr_peak, []

    def rec(cs2, e2, lo, hi, **kw):
        seen.append(((cs2, e2, lo, hi), kw))
        return real(cs2, e2, lo, hi, **kw)

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


def library_peak(cs2, e2, lo, hi, tf32=False):
    """The PyTorch yardstick: one matmul (fp32 SGEMM, or with ``tf32`` the
    1xTF32 one), a [lo, hi] mask, torch.max."""
    import torch

    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high" if tf32 else "highest")
    try:
        cc = torch.matmul(cs2, e2)
    finally:
        torch.set_float32_matmul_precision(prev)
    col = torch.arange(cc.shape[1], device=cc.device)
    bad = (col[None, :] < lo[:, None]) | (col[None, :] > hi[:, None])
    return cc.masked_fill_(bad, float("-inf")).max(dim=1)


def route_bound_ms(flops, nbytes, precision):
    """(bound ms, what bounds it): the larger of the operations over the
    route's peak (fp32 CUDA cores; tf32 tensor cores, three products per
    fp32 multiply-add at 'high') and the bytes over the HBM rate."""
    ops = (flops / PEAK_FP32_FLOPS if precision == "highest" else
           3 * flops / PEAK_TF32_FLOPS if precision == "high" else
           flops / PEAK_TF32_FLOPS)
    mem = nbytes / PEAK_HBM_BYTES
    return max(ops, mem) * 1e3, ("operations" if ops >= mem else "bytes")


def wall_s(fn):
    """Host seconds of ``fn()`` up to the end of the device work it queued."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def device_profile(fn):
    """(device busy seconds, rows) of one call of ``fn`` under the package's
    profiler (`utils.profiling.trace`, then `op_profile_summary`: every
    kernel, memcpy and memset of the trace); rows are (device us, name,
    calls), largest first."""
    import shutil
    import tempfile

    import torch
    from narrow_band_least_squares_tpu_torch.utils import profiling

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(root, exist_ok=True)
    d = tempfile.mkdtemp(prefix="trace-", dir=root)
    try:
        torch.cuda.synchronize()
        with profiling.trace(d):
            fn()
        summary = profiling.op_profile_summary(d)
    finally:
        shutil.rmtree(d, ignore_errors=True)
    return summary["device_busy_s"], [(k["total_s"] * 1e6, k["name"], k["calls"])
                                      for k in summary["kernels"]]


def profile_step(label, pipe, data, steps=5, name="canonical"):
    """Device time by kernel name over a few steps (torch.profiler), and the
    device's busy share of the wall time."""
    wall = []
    busy, rows = device_profile(
        lambda: wall.append(wall_s(lambda: [pipe.run_raw(data) for _ in range(steps)])))
    wall = wall[0]
    log(f"[{label}] profile, {name}, {steps} steps: wall "
        f"{wall / steps * 1e3:.4f} ms/step, device busy "
        f"{busy / steps * 1e3:.4f} ms/step ({100 * busy / wall:.1f}% busy)")
    for dev_us, key, count in rows[:12]:
        log(f"[{label}]   {dev_us / steps / 1e3:9.4f} ms/step  "
            f"{count // steps:4d} calls/step  {key[:90]}")


def fused_work(plan, band_idx, args):
    """(forward FLOPs, inverse FLOPs, bytes) the function needs on these
    inputs: per real window of each band, C*Lb*2K multiply-adds of the
    forward DFT and P*2K*(hi-lo+1) of the inverse (K = Lg + 1, the unpadded
    bins), two FLOPs each; the band rows, the four tables and the two
    outputs, each once."""
    y, hop, maxstart, lo, hi, lm, Cf, Sf, Ec, Es, pairs, W = args
    Bg, C, T = y.shape
    Lg, P = lm.shape[1], pairs.shape[0]
    K = Lg + 1
    span = (hi - lo + 1).flatten().tolist()
    fwd = inv = 0.0
    for g, b in enumerate(band_idx):
        wp = plan.windows[int(b)]
        fwd += wp.n_windows * C * wp.winlensamp * 2 * K
        inv += wp.n_windows * P * 2 * K * span[g]
    nbytes = 4.0 * (y.numel() + Cf.numel() + Sf.numel() + Ec.numel() + Es.numel()
                    + 2 * Bg * W * P)
    return 2.0 * fwd, 2.0 * inv, nbytes


def fused_bound_ms(fwd, inv, nbytes, precision):
    """(bound ms, what bounds it) of the fused route at ``precision``: both
    DFTs' operations at the route's rate (`route_bound_ms`)."""
    return route_bound_ms(fwd + inv, nbytes, precision)


class SmClock:
    """Samples the card's SM clock and power draw (``nvidia-smi``, every
    100 ms) while the block runs: a kernel at the fp32 FMA rate may run
    below the clock its published peak assumes."""

    def __enter__(self):
        self.proc = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
             "--format=csv,noheader,nounits", "-lms", "100"],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        return self

    def __exit__(self, *exc):
        self.proc.terminate()
        out, _ = self.proc.communicate(timeout=30)
        rows = [ln.split(",") for ln in out.splitlines() if ln.count(",") == 1]
        self.mhz = [float(a) for a, _ in rows]
        self.watts = [float(b) for _, b in rows]

    def summary(self) -> str:
        if not self.mhz:
            return "SM clock: no samples"
        return (f"SM clock median {np.median(self.mhz):.0f} MHz (min {min(self.mhz):.0f}, "
                f"max {max(self.mhz):.0f}), power median {np.median(self.watts):.1f} W "
                f"over {len(self.mhz)} samples")


# the fused 'highest' route's variants timed by time_fused: the inverse
# DFT's K parts (fused_xcorr.KPARTS_INV_F32), a cluster's CTAs
FUSED_HIGHEST_VARIANTS = (1, 2, 4)


def fused_highest_variants(args):
    """Device ms of one 'highest' launch on ``args`` with each K-part count
    of the inverse DFT (FUSED_HIGHEST_VARIANTS), in turns, each checked
    against the route's own rho; launches not counted."""
    from narrow_band_least_squares_tpu_torch.ops.kernels import fused_xcorr as FX

    saved = (FX.KPARTS_INV_F32, FX.launches)
    own = FX.fused_xcorr_bucket(*args, precision="highest")[0]
    out = {}
    try:
        for parts in FUSED_HIGHEST_VARIANTS:
            FX.KPARTS_INV_F32 = parts
            run = lambda: FX.fused_xcorr_bucket(*args, precision="highest")
            rho = run()[0]
            if bool(((rho - own).abs() > 2 * KERNEL_RTOL * (1 + own.abs())).any()):
                fail(f"fused_xcorr_bucket 'highest' with {parts} inverse parts moves rho "
                     f"by {float((rho - own).abs().max()):.3e} from the route's own")
            out[parts] = device_ms(run, reps=10)
    finally:
        FX.KPARTS_INV_F32, FX.launches = saved
    return out


def time_fused(label, plans, st, fused_errs, launches_main):
    """Per precision: fused step times, per-bucket and per-step kernel /
    plain / bound on the canonical plan (kernel and bound on dense50), the
    staged 'mxu' delays beside the fused ones, and the multi-array steps.
    Returns the canonical records of the kernels line."""
    from narrow_band_least_squares_tpu_torch.models import (
        MultiArrayPipeline, NarrowBandPipeline,
    )
    from narrow_band_least_squares_tpu_torch.ops.kernels import fused_xcorr as FX
    from narrow_band_least_squares_tpu_torch.utils import get_rij

    rij = get_rij(st.latitudes, st.longitudes, st.nchans)
    recs = []
    for name, plan in plans.items():
        nwin = sum(plan.num_compute_list)
        for prec in PRECISIONS:
            pipe = fused_pipeline(plan, rij, matmul_precision=prec)
            FX.launches = FX.launches_tc = 0
            pipe.run_raw(st.data)
            per_step = (FX.launches, FX.launches_tc)
            ms = cuda_time_ms(lambda: pipe.run_raw(st.data), reps=20)
            log(f"[{label}] {name} fused at {prec}: {ms:.4f} ms per run_raw "
                f"step, {nwin / ms * 1e3:.1f} windows solved/s, "
                f"fused_xcorr_bucket launches per step: fp32 route "
                f"{per_step[0]}, tensor-core route {per_step[1]}")
            if prec == "highest" or (name == "canonical" and prec != "default"):
                profile_step(f"{label} fused {prec}", pipe, st.data, name=name)
        canonical = name == "canonical"
        variants = {v: 0.0 for v in FUSED_HIGHEST_VARIANTS}
        tot = {p: dict(ms=0.0, event_ms=0.0, plain_ms=0.0, fwd=0.0, inv=0.0,
                       nbytes=0.0) for p in PRECISIONS}
        for i, args in enumerate(capture_fused_inputs(pipe, st.data)):
            ff, fi, b = fused_work(plan, pipe._buckets[i]["grid"].band_idx, args)
            f = ff + fi
            parts = []
            for prec in PRECISIONS:
                prepared = FX.prepare(*args[6:10], prec)
                run = lambda: FX.fused_xcorr_bucket(*args, precision=prec,
                                                    prepared=prepared)
                kt = device_ms(run, reps=10)
                et = cuda_time_ms(run, reps=10)
                pt = (device_ms(lambda: FX.fused_xcorr_bucket_reference(
                    *args, precision=prec), reps=3) if canonical else 0.0)
                bound, _ = fused_bound_ms(ff, fi, b, prec)
                parts.append(f"{prec} {kt * 1e3:.1f} ({et * 1e3:.1f})/"
                             + (f"{pt * 1e3:.1f}/" if canonical else "")
                             + f"{bound * 1e3:.1f}")
                t = tot[prec]
                t["ms"] += kt
                t["event_ms"] += et
                t["plain_ms"] += pt
                t["fwd"] += ff
                t["inv"] += fi
                t["nbytes"] += b
            for v, ms in fused_highest_variants(args).items():
                variants[v] += ms
            log(f"[{label}] fused_xcorr_bucket {name} bucket {i}: y "
                f"{tuple(args[0].shape)} Lg={args[5].shape[1]} "
                f"Kp={args[6].shape[1]} nlag={args[8].shape[1]} W={args[11]} "
                f"({f / 1e9:.3f} GFLOP), kernel (events)/"
                + ("plain/" if canonical else "") + "bound us: " + ", ".join(parts))
        log(f"[{label}] fused_xcorr_bucket per {name} step at highest by the "
            f"inverse's K parts, device ms: "
            + ", ".join(f"{k}: {ms:.4f}" for k, ms in variants.items())
            + f"; the route's own: {FX.KPARTS_INV_F32}")
        for prec in PRECISIONS:
            t = tot[prec]
            t["flops"] = t["fwd"] + t["inv"]
            t["bound_ms"], t["bound_by"] = fused_bound_ms(t["fwd"], t["inv"],
                                                          t["nbytes"], prec)
            log(f"[{label}] fused_xcorr_bucket per {name} step at {prec}: kernel "
                f"{t['ms']:.4f} ms (by events {t['event_ms']:.4f} ms)"
                + (f", plain {t['plain_ms']:.4f} ms" if canonical else "")
                + f", bound {t['bound_ms']:.4f} ms by {t['bound_by']} "
                f"({t['flops'] / 1e9:.2f} GFLOP); kernel at "
                f"{t['flops'] / (t['ms'] * 1e-3) / 1e12:.2f} fp32-equivalent "
                f"TFLOP/s; library: none (no single PyTorch call computes "
                f"windows-to-peak)")
            if canonical:
                recs.append({
                    "name": f"fused_xcorr_bucket@{prec}", "route": "cuda",
                    "precision": prec,
                    "source": "narrow_band_least_squares_tpu_torch/csrc/fused_xcorr.cu",
                    "replaces": "narrow_band_least_squares_tpu/ops/kernels/fused_xcorr.py:201",
                    "launches": launches_main.get(prec, 0),
                    "max_abs_err": (fused_errs or {}).get(prec),
                    "ms": t["ms"], "plain_ms": t["plain_ms"],
                    "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                    "library_ms": None,
                })
    plan = plans["canonical"]
    pipe = fused_pipeline(plan, rij)
    mxu = NarrowBandPipeline(plan, rij, filter_type="cheby1", device="cuda")
    y = pipe._filter(pipe._to_device(st.data))
    d_f = device_ms(lambda: pipe._delays(y), reps=10)
    d_m = device_ms(lambda: mxu._delays(y), reps=10)
    log(f"[{label}] canonical delays stage alone at 'high' (device time): fused "
        f"{d_f:.4f} ms, staged 'mxu' (cuBLAS spectra + icorr_peak) {d_m:.4f} ms")

    mplan, rijs, data = multiarray_inputs()
    for method, prec in (("fused", "high"), ("fused", "highest"), ("mxu", "high")):
        multi = MultiArrayPipeline(mplan, rijs, xcorr_method=method,
                                   matmul_precision=prec, device="cuda")
        ms = cuda_time_ms(lambda: multi.run_raw(data), reps=10)
        nwin = len(rijs) * sum(mplan.num_compute_list)
        log(f"[{label}] multiarray A={len(rijs)} {method} at {prec}: {ms:.4f} ms "
            f"per run_raw step, {nwin / ms * 1e3:.1f} windows solved/s")
    return recs


SOURCES = {"highest": "narrow_band_least_squares_tpu_torch/csrc/xcorr_peak.cu",
           "high": "narrow_band_least_squares_tpu_torch/csrc/xcorr_peak_tc.cu",
           "default": "narrow_band_least_squares_tpu_torch/csrc/xcorr_peak_tc.cu"}


def time_icorr(label, name, pipe, data, check):
    """Per bucket and per step of plan ``name``: kernel ms at each
    precision, its bound, the plain version's ms at that precision, and the
    library calls (fp32 SGEMM, and 1xTF32 SGEMM for 'default') + mask +
    max, all as device time (`device_ms`); the kernel also by CUDA events
    over calls as the host issues them (``event_ms``, host gaps included).  The inputs
    are the same at every precision (the spectra are fp32); ``check`` holds
    every bucket against the plain versions.  Returns per precision {ms,
    event_ms, plain_ms, library_ms, bound_ms, bound_by, max_abs_err}."""
    from narrow_band_least_squares_tpu_torch.ops.kernels import xcorr_peak as XP

    tot = {p: dict(ms=0.0, event_ms=0.0, plain_ms=0.0, library_ms=0.0,
                   flops=0.0, nbytes=0.0, max_abs_err=0.0) for p in PRECISIONS}
    seen = capture_icorr_inputs(pipe, data)
    for i, (args, _) in enumerate(seen):
        prep = {p: XP.prepare(args[1], p) for p in PRECISIONS}
        lib = {False: device_ms(lambda: library_peak(*args), reps=5),
               True: device_ms(lambda: library_peak(*args, tf32=True), reps=5)}
        f, b = icorr_work(*args)
        parts = []
        for prec in PRECISIONS:
            t = tot[prec]
            if check:
                err, _ = check_icorr(f"{name} bucket {i}", *args, precision=prec,
                                     prepared=prep[prec])
                t["max_abs_err"] = max(t["max_abs_err"], err)
                if prec == "high":
                    check_icorr(f"{name} bucket {i}", *args, precision=prec,
                                against="highest", prepared=prep[prec])
            run = lambda: XP.icorr_peak(*args, precision=prec, prepared=prep[prec])
            kt = device_ms(run, reps=10)
            et = cuda_time_ms(run, reps=10)
            pt = device_ms(lambda: XP.icorr_peak_reference(*args, precision=prec),
                           reps=3)
            lt = lib[prec == "default"]
            bound, _ = route_bound_ms(f, b, prec)
            parts.append(f"{prec} {kt * 1e3:.1f} ({et * 1e3:.1f})/{pt * 1e3:.1f}/"
                         f"{lt * 1e3:.1f}/{bound * 1e3:.1f}")
            t["ms"] += kt
            t["event_ms"] += et
            t["plain_ms"] += pt
            t["library_ms"] += lt
            t["flops"] += f
            t["nbytes"] += b
        log(f"[{label}] icorr_peak {name} bucket {i}: R={args[0].shape[0]} "
            f"K2p={args[0].shape[1]} nlag={args[1].shape[1]} ({f / 1e9:.3f} "
            f"GFLOP), kernel (events)/plain/library/bound us: " + ", ".join(parts))
    for prec in PRECISIONS:
        t = tot[prec]
        t["bound_ms"], t["bound_by"] = route_bound_ms(t["flops"], t["nbytes"], prec)
        lib = "1xTF32 SGEMM" if prec == "default" else "fp32 SGEMM"
        log(f"[{label}] icorr_peak per {name} step at {prec} ({len(seen)} "
            f"launches): kernel {t['ms']:.4f} ms (by events {t['event_ms']:.4f} "
            f"ms), plain {t['plain_ms']:.4f} ms, "
            f"library ({lib} + mask + max) {t['library_ms']:.4f} ms, bound "
            f"{t['bound_ms']:.4f} ms by {t['bound_by']} ({t['flops'] / 1e9:.2f} "
            f"GFLOP); kernel at {t['flops'] / (t['ms'] * 1e-3) / 1e12:.2f} "
            f"fp32-equivalent TFLOP/s")
    return tot


def phase_timing(label, launches_main):
    """Steps at each precision on the canonical and dense50 plans, the
    profile of the canonical 'mxu' step at 'high' and 'highest', and
    icorr_peak per bucket.  Returns the canonical icorr_peak records."""
    import torch
    from narrow_band_least_squares_tpu_torch.models import NarrowBandPipeline
    from narrow_band_least_squares_tpu_torch.ops.kernels import xcorr_peak as XP
    from narrow_band_least_squares_tpu_torch.utils import get_rij, make_plan

    st, freqlist, winlens = canonical_inputs()
    rij = get_rij(st.latitudes, st.longitudes, st.nchans)
    plans = {"canonical": make_plan(freqlist, "log", winlens, WINOVER,
                                    st.npts, st.fs)}
    plans["dense50"] = dense50_plan(st)

    recs = []
    for name, plan in plans.items():
        nwin = sum(plan.num_compute_list)
        for prec in PRECISIONS:
            pipe = NarrowBandPipeline(plan, rij, filter_type="cheby1", alpha=1.0,
                                      matmul_precision=prec, device="cuda")
            XP.launches = XP.launches_tc = 0
            pipe.run_raw(st.data)
            per_step = XP.launches + XP.launches_tc
            ms = cuda_time_ms(lambda: pipe.run_raw(st.data), reps=20)
            log(f"[{label}] {name} at {prec}: {ms:.4f} ms per run_raw step, "
                f"{nwin / ms * 1e3:.1f} windows solved/s, icorr_peak launches "
                f"per step {per_step}")
            if name == "canonical" and prec != "default":
                profile_step(f"{label} {prec}", pipe, st.data)
        torch.cuda.synchronize()
        tot = time_icorr(label, name, pipe, st.data, check=name == "canonical")
        if name != "canonical":
            continue
        for prec in PRECISIONS:
            t = tot[prec]
            recs.append({
                "name": f"icorr_peak@{prec}", "route": "cuda",
                "precision": prec, "source": SOURCES[prec],
                "replaces": "narrow_band_least_squares_tpu/ops/kernels/xcorr_peak.py:94",
                "launches": launches_main.get(prec, 0),
                "max_abs_err": t["max_abs_err"], "ms": t["ms"],
                "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            })
    return recs, plans, st


# --------------------------------------------------------------------------
# the step replayed from CUDA graphs
# --------------------------------------------------------------------------

def graph_counts():
    from narrow_band_least_squares_tpu_torch.models import narrowband as NB

    return {k: getattr(NB, k) for k in
            ("eager_steps", "graph_captures", "graph_replays", "graph_fallbacks")}


def zero_graph_counts():
    from narrow_band_least_squares_tpu_torch.models import narrowband as NB

    NB.eager_steps = NB.graph_captures = NB.graph_replays = NB.graph_fallbacks = 0


def differing(got, want) -> int:
    """Elements whose float32 (or bool) bits differ."""
    got, want = np.asarray(got), np.asarray(want)
    if got.shape != want.shape:
        return max(got.size, want.size)
    if want.dtype == bool:
        return int((got != want).sum())
    return int((got.astype(np.float32).view(np.uint32)
                != want.astype(np.float32).view(np.uint32)).sum())


def graph_against_eager(name, pipe, streams):
    """`pipe.run` on ``streams`` (an eager first call, a capture, replays)
    against `pipe.run_raw` (eager) of each segment, bit for bit."""
    zero_graph_counts()
    pipe.run(streams[0])
    bad = 0
    for st in streams[1:]:
        res = pipe.run(st)
        raw = {k: v.cpu().numpy() for k, v in pipe.run_raw(st.data).items()}
        W = raw["vel"].shape[-1]
        for k in ("vel", "baz", "mdccm", "sig_tau", "vel_uncert", "baz_uncert"):
            bad += differing(getattr(res, k + "_array")[:, :W], raw[k])
        if "flags" in raw or res.flags is not None:
            bad += differing(res.flags, raw["flags"])
    return bad


def check_graph_counts(name, pipe, want_replays):
    counts = graph_counts()
    want = {"eager_steps": 1, "graph_captures": 1, "graph_replays": want_replays,
            "graph_fallbacks": 0}
    if counts != want:
        fail(f"graph {name}: step counts {counts}, not {want}")
    g = pipe._graphs
    return g.graphs, sum(op != "graph" for op, _ in g.program) // 2


def graph_timing(label, name, pipe, twin, streams):
    """Host ms of graphed `run` (``pipe``) and eager `run` (``twin``, its
    graphs off) in turns, to the end of the call (its copies wait for the
    device)."""
    twin.run(streams[0])
    times = {"graph": [], "eager": []}
    for i in range(GRAPH_TURNS):
        st = streams[i % len(streams)]
        order = (("graph", pipe), ("eager", twin)) if i % 2 == 0 else \
            (("eager", twin), ("graph", pipe))
        for side, p in order:
            times[side].append(wall_s(lambda: p.run(st)) * 1e3)
    med = {k: float(np.median(v)) for k, v in times.items()}
    log(f"[{label}] graph {name}: run {med['graph']:.3f} ms graphed, "
        f"{med['eager']:.3f} ms eager (medians of {GRAPH_TURNS} in turns; graphed "
        f"{sorted(round(v, 3) for v in times['graph'])}, eager "
        f"{sorted(round(v, 3) for v in times['eager'])})")


def phase_graph(label):
    """Graphed `run` bit for bit eager `run_raw` over GRAPH_SEGMENTS
    segments in every configuration the step's code paths differ in, one
    capture and no fallback each; a replay advances no launch counter;
    graphed against eager `run` on the benchmark's two plans."""
    import torch
    from narrow_band_least_squares_tpu_torch import api
    from narrow_band_least_squares_tpu_torch.io import synthetic_plane_wave
    from narrow_band_least_squares_tpu_torch.models import NarrowBandPipeline
    from narrow_band_least_squares_tpu_torch.models import narrowband as NB
    from narrow_band_least_squares_tpu_torch.ops.kernels import xcorr_peak as XP
    from narrow_band_least_squares_tpu_torch.utils import (
        get_freqlist, get_rij, get_winlenlist, make_plan,
    )

    def streams(outliers=()):
        return [synthetic_plane_wave(
            nchans=NCHANS, duration_s=DURATION_S, fs=FS, baz_deg=(37.0 + 61.0 * k) % 360.0,
            trace_vel_kms=0.30 + 0.02 * k, f0=0.8, bandwidth=1.2, snr=8.0,
            seed=SEED + 100 + k, outlier_channels=outliers)
            for k in range(GRAPH_SEGMENTS + 1)]

    segs = streams()
    rij = get_rij(segs[0].latitudes, segs[0].longitudes, NCHANS)
    winlens = {}
    plans = {}
    for kind in ("log", "onethird_octave"):
        fl, nb, _ = get_freqlist(FMIN, FMAX, kind, NBANDS)
        winlens[kind] = get_winlenlist("adaptive", nb, WINLEN, WINLEN_1, WINLEN_X)
        plans[kind] = make_plan(fl, kind, winlens[kind], WINOVER, segs[0].npts, FS)
    configs = [
        ("i53_example mxu high", "log", {}),
        ("i53_onethird mxu high", "onethird_octave", {}),
        ("fused high", "log", {"xcorr_method": "fused"}),
        ("fused highest", "log", {"xcorr_method": "fused", "matmul_precision": "highest"}),
        ("mxu highest", "log", {"matmul_precision": "highest"}),
        ("mxu default", "log", {"matmul_precision": "default"}),
        ("mxu high subsample", "log", {"subsample_delays": True}),
        ("lts 0.75", "log", {"alpha": LTS_ALPHA}),
    ]
    lts_segs = None
    for name, kind, kw in configs:
        data = segs
        if kw.get("alpha", 1.0) < 1.0:
            data = lts_segs = streams(outliers=(LTS_OUTLIER,))
        pipe = NarrowBandPipeline(plans[kind], rij, device="cuda", **kw)
        t0 = time.perf_counter()
        bad = graph_against_eager(name, pipe, data)
        secs = time.perf_counter() - t0
        graphs, spans = check_graph_counts(name, pipe, GRAPH_SEGMENTS)
        if bad:
            fail(f"graph {name}: {bad} elements of graphed run differ from eager run_raw")
        log(f"[{label}] graph {name}: {GRAPH_SEGMENTS} graphed calls bit for bit eager "
            f"run_raw (0 differing elements), {graphs} graphs and {spans} spans a step, "
            f"1 capture, 0 fallbacks ({secs:.2f} s with the checks)")
        if name == "i53_example mxu high":
            zero_launches()
            pipe.run(data[1])
            replayed = lag_search_launches()
            pipe.run_raw(data[1].data)
            eager = lag_search_launches()
            torch.cuda.synchronize()
            if replayed != (0, 0, 0, 0) or eager[1] != len(pipe._buckets):
                fail(f"graph: a replay must advance no launch counter ({replayed}) and an "
                     f"eager step one a bucket ({eager})")
        if name.startswith("i53_"):
            twin = NarrowBandPipeline(plans[kind], rij, device="cuda", **kw)
            twin._graph_backend = None
            graph_timing(label, name, pipe, twin, data[1:])
        del pipe
        torch.cuda.synchronize()

    # one-band ltsva through the API: its cached pipeline replays
    stfs = [api.filter_data(st, "cheby1", FMIN, FMAX, 2, 0.01, device="cpu")[0]
            for st in lts_segs]
    first_call()
    zero_graph_counts()
    args = (stfs[0].latitudes, stfs[0].longitudes, WINLEN, WINOVER, LTS_ALPHA)
    api.ltsva(stfs[0], *args, device="cuda")
    plan = make_plan([0.0, FS / 2], "linear", [WINLEN], WINOVER, stfs[0].npts, FS)
    pipe = api._get_pipeline(plan, get_rij(*args[:2], NCHANS), alpha=LTS_ALPHA,
                             apply_filter=False, device="cuda")
    bad = 0
    for stf in stfs[1:]:
        out = api.ltsva(stf, *args, device="cuda")
        raw = {k: v.cpu().numpy() for k, v in pipe.run_raw(stf.data).items()}
        n = len(out[0])
        for i, k in ((0, "vel"), (1, "baz"), (3, "mdccm"), (5, "sig_tau"),
                     (6, "vel_uncert"), (7, "baz_uncert")):
            bad += differing(out[i], raw[k][0, :n])
        want = NB.flags_to_stdict(raw["flags"][:, :n], out[2][None, :], [n],
                                  pipe.pairs_np, NCHANS, band_prefix=False)
        if set(want) != set(out[4]) or any(
                not np.array_equal(want[k], out[4][k]) for k in want if k != "size"):
            bad += 1
    graphs, spans = check_graph_counts("ltsva", pipe, GRAPH_SEGMENTS)
    if bad:
        fail(f"graph one-band ltsva: {bad} elements differ from eager run_raw")
    log(f"[{label}] graph one-band ltsva (ALPHA {LTS_ALPHA}): {GRAPH_SEGMENTS} graphed "
        f"API calls bit for bit eager run_raw, stdict included; {graphs} graphs and "
        f"{spans} spans a step, 1 capture, 0 fallbacks")
    first_call()


def sass_functions(lib):
    """{mangled name: SASS lines} of every kernel in a built library."""
    from narrow_band_least_squares_tpu_torch.ops.kernels import _build

    funcs, name = {}, None
    for ln in _build.sass(lib).splitlines():
        if ln.strip().startswith("Function :"):
            name = ln.split(":", 1)[1].strip()
            funcs[name] = []
        elif name is not None:
            funcs[name].append(ln.strip())
    return funcs


def check_sass():
    """The tensor-core libraries must hold tf32 HGMMA (wgmma) instructions;
    the fp32 ('highest') kernels of both lag searches FFMA and no tensor-core
    instruction (3xTF32 would also pass their tolerance)."""
    import re
    from narrow_band_least_squares_tpu_torch.ops.kernels import fused_xcorr as FX
    from narrow_band_least_squares_tpu_torch.ops.kernels import xcorr_peak as XP

    for lib in ("xcorr_peak_tc", "fused_xcorr"):
        sass = [ln for body in sass_functions(lib).values() for ln in body]
        hgmma = [ln for ln in sass if re.search(r"HGMMA\S*TF32", ln)]
        if not hgmma:
            mma = [ln for ln in sass if "MMA" in ln][:5]
            fail(f"{lib}'s SASS holds no HGMMA with TF32 operands; its MMA "
                 f"lines: {mma}")
        log(f"{lib} SASS: {len(hgmma)} tf32 HGMMA, e.g. {hgmma[0][:100]}")
    fp32 = {"fused_xcorr": "ring_tile_kernel", "xcorr_peak": "icorr_peak_tile_kernel"}
    for lib, kernel in fp32.items():
        funcs = {k: v for k, v in sass_functions(lib).items() if kernel in k}
        if not funcs:
            fail(f"{lib}'s SASS has no {kernel}")
        for name, body in funcs.items():
            ffma = sum(bool(re.search(r"\bFFMA\b", ln)) for ln in body)
            mma = [ln for ln in body if re.search(r"\b(HGMMA|HMMA|IMMA)\b", ln)]
            if mma or not ffma:
                fail(f"{lib} {name[:60]}: the fp32 route must be FFMA only; "
                     f"{ffma} FFMA, tensor-core lines {mma[:3]}")
            log(f"{lib} {name[:70]}: {ffma} FFMA, no HGMMA/HMMA (IEEE fp32)")
    lib = XP._lib_tc()
    log(f"tensor-core tile dynamic shared memory: "
        f"{lib.nbls_icorr_peak_tc_smem_bytes(3)} B at 'high', "
        f"{lib.nbls_icorr_peak_tc_smem_bytes(1)} B at 'default'")
    lib = FX._lib()
    clusters = ", ".join(
        f"{what} x{parts}: {lib.nbls_fused_xcorr_max_clusters(store, parts)}"
        for what, store in (("inverse", 0), ("forward", 1)) for parts in (1, 2, 4))
    log(f"fused fp32 ring tile (64 x 128, 8 x 8 a thread, 128 threads): "
        f"{lib.nbls_fused_xcorr_ring_smem()} B dynamic shared memory a CTA; "
        f"clusters (1, 1, parts) the card holds at once "
        f"(cudaOccupancyMaxActiveClusters): {clusters}; the route's K parts, "
        f"each one cluster: the inverse's {FX.KPARTS_INV_F32}, the forward's "
        f"{FX.KSPLIT_F32} (fewer where Lg is short)")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of " + ",".join(PHASES))
    phases = set(ap.parse_args().phases.split(","))
    if not phases <= set(PHASES):
        fail(f"unknown phases {sorted(phases - set(PHASES))}")

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

    import threading

    from narrow_band_least_squares_tpu_torch import native

    t0 = time.perf_counter()
    host = threading.Thread(target=native.get_lib)   # g++ beside the nvcc builds
    host.start()
    report = _build.build_all()
    host.join()
    log(f"kernel build: {time.perf_counter() - t0:.2f} s for {sorted(report)}")
    native_lib()
    log(f"native runtime (g++, miniSEED codec, ring buffer, TSV codec): built in "
        f"{native.build_seconds:.2f} s into {native.target()}")
    for name, r in report.items():
        for line in r["ptxas"].splitlines():
            if any(w in line for w in ("entry function", "registers", "spill", "smem")):
                log(f"  {name}: {line.strip()}")
    check_sass()
    phase_done("build")

    if "kernel" in phases:
        phase_kernel()
        phase_done("kernel")
    launches = {}
    if "main" in phases:
        launches = phase_main()
        phase_done("main")
    fused_errs = fused_launches = None
    if "fused-kernel" in phases:
        fused_errs = phase_fused_kernel()
        phase_done("fused-kernel")
    if "fused-main" in phases:
        fused_launches = phase_fused_main()
        phase_done("fused-main")
    if "multiarray" in phases:
        phase_multiarray()
        phase_done("multiarray")
    if "sharded" in phases:
        phase_sharded(label)
        phase_done("sharded")
    lrecs = []
    if "lts" in phases:
        lrecs = phase_lts(label)
        phase_done("lts")
    if "monitor" in phases:
        phase_monitor(label)
        phase_done("monitor")
    if "ingest" in phases:
        phase_ingest(label)
        phase_done("ingest")
    if "golden" in phases:
        phase_golden(label)
        phase_done("golden")
    if "cli" in phases:
        phase_cli(label)
        phase_done("cli")
    recs = []
    if "options" in phases:
        orecs = phase_options(label)
        phase_done("options")
    if "timing" in phases:
        recs, plans, st = phase_timing(label, launches)
        phase_done("timing (icorr_peak)")
        recs += time_fused(label, plans, st, fused_errs, fused_launches or {})
        phase_done("timing (fused)")
    if "graph" in phases:
        phase_graph(label)
        phase_done("graph")
    if "options" in phases:
        recs += orecs
    recs += lrecs
    if recs:
        log(f"[{label}]")
        log(json.dumps({"kernels": recs}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
