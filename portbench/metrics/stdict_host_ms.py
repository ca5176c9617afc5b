"""Layer: Flags (host).  The mean duration a call of the program's
``nbls.stdict`` span: the host turning an LTS call's flags into the
reference's ``stdict`` of flagged elements, one key a valid window (calls
wholly inside the traced window, ``harness/spans.py``), in ms.  Nothing to
read without the span (an OLS call, or a program that records none)."""

from portbench.harness import spans


def read(ctx):
    return spans.of(ctx.trace).per_call_ms("nbls.stdict")
