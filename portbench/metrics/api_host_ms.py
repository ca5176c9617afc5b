"""Layer: API shim.  The mean host time a call of the program's ``nbls.api``
span outside its ``nbls.step`` and ``nbls.package`` children: the
geometry, the plan, the pipeline's lookup and building the returned tuple
(calls wholly inside the traced window, ``harness/spans.py``), in
ms.  Nothing to read without the span."""

from portbench.harness import spans


def read(ctx):
    return spans.of(ctx.trace).api_host_ms()
