"""Layer: API shim.  The archive's rate as the traced window reads it: the
plan's windows of every segment whose answer reached the caller, over the
window's seconds.  A network's segment carries its A arrays' windows
(``ctx.arrays``; a context without it is one array's).  The profiler slows
the host, so it reads below the untraced rate."""


def read(ctx):
    if ctx.segments <= 0 or ctx.window_s <= 0:
        return None
    arrays = getattr(ctx, "arrays", 1)
    return ctx.segments * sum(ctx.deployment.num_compute_list) * arrays / ctx.window_s
