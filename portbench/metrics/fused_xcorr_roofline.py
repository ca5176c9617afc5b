"""Layer: Lag search.  The bound of the window's fused lag searches (one a
real segment, ``counts/fused_xcorr.py`` at the precision the pipeline
reports: the forward DFT of every window and element and the inverse DFT
at the lags) over the device time of the operations launched inside the
program's ``nbls.lag_search`` span (by launch correlation,
``harness/spans.py``), in percent.  On the fused route that span holds the
``fused_xcorr_bucket`` launches alone, every pass of the kernel.  Nothing
to read where the route is not 'fused' (the span then holds the inverse
DFT alone, a different work) or without the span."""

from portbench.harness import spans


def read(ctx):
    if ctx.route["xcorr_method"] != "fused":
        return None
    ms = spans.of(ctx.trace).device_ms_per_segment("nbls.lag_search", ctx.segments)
    if ms is None:
        return None
    dep = ctx.deployment
    counts = ctx.spec.module("counts", "fused_xcorr")
    bound = counts.bound_seconds([wp.winlensamp for wp in dep.windows],
                                 [wp.n_windows for wp in dep.windows],
                                 int(ctx.cfg["NCHANS"]), dep.npts, ctx.route["precision"])
    return 100.0 * bound * 1e3 / ms
