"""Layer: Solve.  The bound of the window's LTS solves (one a real segment,
``counts/lts_solve.py`` at the configuration's ALPHA and C-steps) over the
device time of the operations launched inside the program's ``nbls.solve``
span (by launch correlation, ``harness/spans.py``), in percent.  The time
is the span's, not a list of kernel names, so a redesign that renames or
merges the solve's kernels keeps a reading; the span also holds the
solve's small glue operations and the window mask, which the bound does
not count.  Nothing to read for an OLS configuration, with a funnel (the
count sweeps every candidate), or without the span."""

from portbench.harness import spans


def read(ctx):
    dep = ctx.deployment
    if dep.alpha >= 1.0 or dep.funnel:
        return None
    ms = spans.of(ctx.trace).device_ms_per_segment("nbls.solve", ctx.segments)
    if ms is None:
        return None
    counts = ctx.spec.module("counts", "lts_solve")
    nchans = int(ctx.cfg["NCHANS"])
    bound = counts.bound_seconds(sum(dep.num_compute_list), nchans * (nchans - 1) // 2,
                                 dep.alpha, dep.c_steps)
    return 100.0 * bound * 1e3 / ms
