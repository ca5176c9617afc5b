"""Layer: Step dispatch (host).  The device operations (kernels, copies,
memsets) in the traced window over the real segments whose answers the
window completed: a padded segment of a monitor's batch is work, not a
segment."""


def read(ctx):
    if not ctx.trace.device or ctx.segments <= 0:
        return None
    return len(ctx.trace.device) / ctx.segments
