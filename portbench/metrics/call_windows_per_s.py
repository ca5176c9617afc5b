"""Layer: API shim.  The archive's rate as the traced window reads it: the
plan's windows of every segment whose answer reached the caller, over the
window's seconds.  The profiler slows the host, so it reads below the
untraced rate."""


def read(ctx):
    if ctx.segments <= 0 or ctx.window_s <= 0:
        return None
    return ctx.segments * sum(ctx.deployment.num_compute_list) / ctx.window_s
