"""Operations and bytes of the inverse-DFT lag search of one 1200 s
segment, from the plan's shapes alone, and its bound on one H100.

The lag search of a band of windows ``L`` samples long is, for each window
and element pair, the cross-spectrum's ``L + 1`` bins of a ``2 L``-point
DFT (``2 (L + 1)`` real numbers) taken against each of the ``2 L - 1``
lags, followed by the first maximum.  Operations: ``2 * 2 (L + 1)`` a
searched lag.  Bytes: the cross-spectra, the band's table of lags and the
outputs (a peak and a lag a row), each read or written once.  Each band
counts its own windows and its own length: no bucket of bands, no padding
to a common length or to an alignment, so the count stays what the plan
needs whatever a route pads.  At 'high' each multiply-add is three tf32
products.
"""

from __future__ import annotations

from typing import Dict

from portbench.harness.peaks import H100

# tf32 products a float32 multiply-add takes at each precision
TF32_PRODUCTS = {"high": 3, "default": 1}


def work(lens, wins, pairs: int) -> Dict[str, float]:
    """``{"flops", "bytes"}`` of one segment's lag search: ``lens`` the
    bands' window lengths in samples, ``wins`` their window counts."""
    flops = nbytes = 0.0
    for L, W in zip(lens, wins):
        L, rows = int(L), int(W) * pairs
        bins, lags = 2 * (L + 1), 2 * L - 1
        flops += 2.0 * bins * lags * rows
        nbytes += 4.0 * (rows * bins + bins * lags + 2 * rows)
    return {"flops": flops, "bytes": nbytes}


def bound_seconds(lens, wins, pairs: int, precision: str) -> float:
    """The least time one H100 takes for one segment's lag search at
    ``precision``: the larger of its operations at that precision's peak
    and its bytes at the HBM rate."""
    w = work(lens, wins, pairs)
    if precision == "highest":
        ops = w["flops"] / H100["fp32_flops"]
    else:
        ops = TF32_PRODUCTS[precision] * w["flops"] / H100["tf32_flops"]
    return max(ops, w["bytes"] / H100["hbm_bytes"])
