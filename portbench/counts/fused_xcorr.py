"""Operations and bytes of the fused lag search of one 1200 s segment (the
port's ``xcorr_method='fused'``: windows, forward DFT, cross-spectra and
inverse DFT in one kernel a bucket), from the plan's shapes alone, and its
bound on one H100.

For a band of windows ``L`` samples long:

- the forward DFT of each window and element: ``L`` samples against the
  ``L + 1`` bins of a ``2 L``-point DFT, real and imaginary, ``2 * L * 2 (L
  + 1)`` operations a (window, element);
- the inverse DFT at the lags and its first maximum, a (window, pair):
  `counts.lag_search.work`, the same count as the 'mxu' route's lag search.

The cross-spectra (6 operations a bin and pair, 0.06 GFLOP a canonical
segment and 0.13 in third octaves) are left out: the two products bound
the kernel, and without them the bound at 'highest' is exactly PERF.md
§6's fused row (1.280 ms a canonical step).  Bytes: each band's filtered
rows read once, its forward tables (cos and sin, ``L x (L + 1)``), its
table of lags (as `counts.lag_search`) and the outputs (a peak and a lag a
row); the windows, spectra and cross-spectra stay on chip.  Each band
counts its own windows and length, no bucket and no padding, so the count
stays what the plan needs whatever the kernel pads.  Off 'highest' each
multiply-add is `counts.lag_search.TF32_PRODUCTS` tf32 products.
"""

from __future__ import annotations

from typing import Dict

from portbench.counts import lag_search as LAG_SEARCH
from portbench.harness.peaks import H100

FLOAT = 4                      # float32 bytes


def forward(lens, wins, nchans: int) -> float:
    """Operations of the forward DFTs of one segment: ``lens`` the bands'
    window lengths in samples, ``wins`` their window counts."""
    return sum(2.0 * int(L) * 2 * (int(L) + 1) * int(W) * nchans for L, W in zip(lens, wins))


def work(lens, wins, nchans: int, npts: int) -> Dict[str, float]:
    """``{"flops", "forward", "inverse", "bytes"}`` of one segment's fused
    lag search over ``nchans`` elements and ``npts`` samples a row."""
    pairs = nchans * (nchans - 1) // 2
    inverse = LAG_SEARCH.work(lens, wins, pairs)["flops"]
    fwd = forward(lens, wins, nchans)
    nbytes = 0.0
    for L, W in zip(lens, wins):
        L, rows = int(L), int(W) * pairs
        bins, lags = 2 * (L + 1), 2 * L - 1
        nbytes += FLOAT * (nchans * npts + 2 * L * (L + 1) + bins * lags + 2 * rows)
    return {"flops": fwd + inverse, "forward": fwd, "inverse": inverse, "bytes": nbytes}


def bound_seconds(lens, wins, nchans: int, npts: int, precision: str) -> float:
    """The least time one H100 takes for one segment's fused lag search at
    ``precision``: the larger of its operations at that precision's peak
    and its bytes at the HBM rate."""
    w = work(lens, wins, nchans, npts)
    if precision == "highest":
        ops = w["flops"] / H100["fp32_flops"]
    else:
        ops = LAG_SEARCH.TF32_PRODUCTS[precision] * w["flops"] / H100["tf32_flops"]
    return max(ops, w["bytes"] / H100["hbm_bytes"])
