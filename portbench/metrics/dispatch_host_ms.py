"""Layer: Step dispatch (host).  The mean duration a call of the program's
``nbls.step`` span: the host's time to copy the segment in and enqueue the
step (calls wholly inside the traced window, ``harness/spans.py``), in
ms.  Nothing to read without the span."""

from portbench.harness import spans


def read(ctx):
    return spans.of(ctx.trace).per_call_ms("nbls.step")
