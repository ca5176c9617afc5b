"""Layer: Packaging (host).  The mean duration a call of the program's
``nbls.package`` span: the filters' frequency responses, the
device-to-host copies and their wait for the step, and the result on the
host (calls wholly inside the traced window, ``harness/spans.py``), in
ms.  Nothing to read without the span."""

from portbench.harness import spans


def read(ctx):
    return spans.of(ctx.trace).per_call_ms("nbls.package")
