"""Comparisons, operations and bytes of the least-trimmed-squares solve of
one 1200 s segment, from the plan's shapes alone, and its bound on one H100.

A window's solve has P delay equations (the element pairs) and keeps
``h = floor(ALPHA P)`` of them (at least 3, `reference.batched.lts_h`).
Its candidates are the ``Q = P (P - 1) / 2`` elemental pairs of equations,
each solved exactly for a slowness; each candidate then takes ``c_steps``
concentration steps and its trimmed objective; the final subset is that of
the first minimum.

- Elemental solve, a candidate: the 2x2 inverse (a table of the array's
  geometry, read once) times the two delays, 6 operations.  Bytes: the
  delays, the table, the candidates' slownesses written.
- Sweep, a candidate: each C-step forms P squared residuals (two products,
  two sums, a square: 5 P), ranks them and refits on the h smallest (five
  sums of h products, 10 h, and the 2x2 solve, 11); the objective forms
  the squared residuals again and sums the h smallest (5 P + h - 1).  The
  ranks are what bounds it: each of the ``c_steps + 1`` rank passes
  compares every unordered pair of the P residuals once, P (P - 1) / 2
  comparisons.  Bytes: the delays, the co-array and the slownesses read,
  the refined slownesses and the objectives written.
- Final subset, a window: the first minimum of the Q objectives (Q - 1
  comparisons), one rank pass of its fit's residuals, the refit on the h
  kept (two residual passes, 10 P; the refit, 10 h + 11), sigma_tau (h + 2)
  and the 2x2 uncertainty ellipse (41).  Bytes: the objectives, the
  minimum's fit and the delays read, five values a window and a byte a
  flag written.

Only the plan's valid windows count (no padding to the longest band's
window count, no padded candidates), so the count stays what the
deployment needs whatever the port pads or launches.
"""

from __future__ import annotations

from typing import Dict

from portbench.harness.peaks import H100
from portbench.reference.batched import lts_h

# Comparisons a second of one H100 SXM: 64 an SM a clock (the rate of an
# SM's 64 INT32 lanes, the Hopper architecture white paper; integer and
# float comparisons issue on that pipe) x 132 SMs x 1.98 GHz (the boost
# clock).  16.7e12.
PEAK_COMPARES = 64 * 132 * 1.98e9
FLOAT = 4                      # float32 bytes


def work(windows: int, P: int, alpha: float, c_steps: int) -> Dict[str, float]:
    """``{"comparisons", "flops", "bytes"}`` of one segment's LTS solve:
    ``windows`` the plan's valid windows over every band, ``P`` the
    equations (element pairs) a window, ``c_steps`` the C-steps a
    candidate, every candidate swept (no funnel)."""
    W, h = int(windows), lts_h(alpha, P)
    Q = P * (P - 1) // 2
    n = W * Q                                   # (window, candidate) rows
    rank_pass = P * (P - 1) // 2
    comparisons = n * (c_steps + 1) * rank_pass + W * (Q - 1 + rank_pass)
    flops = (6.0 * n                                              # elemental
             + n * (c_steps * (5 * P + 10 * h + 11) + 5 * P + h - 1)   # sweep
             + W * (10 * P + 10 * h + 11 + h + 2 + 41))          # final subset
    tau, X, table = W * P * FLOAT, P * 2 * FLOAT, Q * (4 * FLOAT + 2 * FLOAT)
    nbytes = ((tau + table + n * 2 * FLOAT)                      # elemental
              + (tau + X + n * 2 * FLOAT + n * 2 * FLOAT + n * FLOAT)   # sweep
              + (n * FLOAT + W * 2 * FLOAT + tau + X + W * 5 * FLOAT + W * P))  # final
    return {"comparisons": float(comparisons), "flops": flops, "bytes": float(nbytes)}


def bound_seconds(windows: int, P: int, alpha: float, c_steps: int) -> float:
    """The least time one H100 takes for one segment's LTS solve: the
    largest of its comparisons at `PEAK_COMPARES`, its float32 operations
    at the CUDA cores' peak and its bytes at the HBM rate."""
    w = work(windows, P, alpha, c_steps)
    return max(w["comparisons"] / PEAK_COMPARES, w["flops"] / H100["fp32_flops"],
               w["bytes"] / H100["hbm_bytes"])
