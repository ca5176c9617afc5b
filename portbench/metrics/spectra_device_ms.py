"""Layer: Forward DFT and cross-spectra.  Device time a segment of the
operations launched inside the program's ``nbls.spectra`` spans: the
energies, the forward-DFT products and the cross-spectra (by launch
correlation, ``harness/spans.py``), in ms.  The 'fused' route forms them
inside its lag search: nothing to read there.  Nothing to read without the
span."""

from portbench.harness import spans


def read(ctx):
    return spans.of(ctx.trace).device_ms_per_segment("nbls.spectra", ctx.segments)
