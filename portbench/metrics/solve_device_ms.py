"""Layer: Solve.  Device time a segment of the operations launched inside the
program's ``nbls.solve`` span: OLS or LTS and the window mask (by launch
correlation, ``harness/spans.py``), in ms.  Nothing to read without the
span."""

from portbench.harness import spans


def read(ctx):
    return spans.of(ctx.trace).device_ms_per_segment("nbls.solve", ctx.segments)
