"""Layer: Lag search.  The bound of the window's lag searches (one a real
segment, ``counts/lag_search.py`` at the precision the pipeline reports)
over the device time of the kernels that perform them, in percent.  The
kernels are every route's: ``icorr_peak``'s tiles, its tf32 split and
merge, and ``fused_xcorr_bucket``'s passes, so a change of route keeps a
reading.  Nothing to read where none of them ran."""

import re

KERNELS = (
    # icorr_peak ('mxu', 'pallas'): tensor-core and fp32 tiles, split, merges
    "tc_tile_kernel", "tf32_split_kernel", "peak_merge_kernel", "peak_merge_nb_kernel",
    "icorr_peak_tile_kernel",
    # fused_xcorr_bucket ('fused'): its passes and tiles
    "ring_tile_kernel", "window_stats_kernel", "windows_kernel", "windows_t_kernel",
    "spectra_sum_kernel", "cross_kernel", "cross_t_kernel", "merge_kernel",
)
PATTERN = re.compile(r"\b(" + "|".join(KERNELS) + r")\b")


def read(ctx):
    us = sum(float(e.get("dur", 0.0)) for e in ctx.trace.device
             if PATTERN.search(e.get("name", "")))
    if us <= 0 or ctx.segments <= 0:
        return None
    counts = ctx.spec.module("counts", "lag_search")
    dep = ctx.deployment
    lens = [wp.winlensamp for wp in dep.windows]
    wins = [wp.n_windows for wp in dep.windows]
    pairs = dep_pairs(int(ctx.cfg["NCHANS"]))
    bound = counts.bound_seconds(lens, wins, pairs, ctx.route["precision"])
    return 100.0 * bound * ctx.segments / (us * 1e-6)


def dep_pairs(nchans: int) -> int:
    return nchans * (nchans - 1) // 2
