"""Layer: Window extraction.  Device time a segment of the operations launched
inside the program's ``nbls.windows`` spans (by launch correlation,
``harness/spans.py``), in ms.  The 'fused' route extracts its windows
inside its lag search: nothing to read there.  Nothing to read without the
span."""

from portbench.harness import spans


def read(ctx):
    return spans.of(ctx.trace).device_ms_per_segment("nbls.windows", ctx.segments)
