"""The comparison that decides ``correct``.

Each answer checked (a segment's results as the caller received them) is
held against `reference.batched.solve_segment` on the same samples:

- ``missing``: answers due in the window that never came, or came with
  other windows than the reference's (counts, or a time off by half a
  sample or more).  Exact: the limit is 0.
- ``mdccm_err``: the largest |MdCCM - reference| over every window
  compared.  MdCCM is continuous through a near tie of two lags (both
  peaks are nearly equal), so it reads the arithmetic's precision.
- ``window_share``: the share of windows whose solve is off the
  reference's beyond ``window_tolerance`` (relative trace velocity,
  back-azimuth in degrees, relative sigma_tau): what a lag moved by the
  arithmetic does to a window.

The limits are the configuration's ``guarantee``.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

SECONDS_PER_DAY = 86400.0


class Tally:
    def __init__(self, guarantee: dict, fs: float):
        self.g, self.fs = guarantee, fs
        self.due = self.missing = self.windows = self.mismatched = 0
        self.mdccm_err = 0.0
        self.notes: List[str] = []

    def add(self, name: str, ans: Optional[dict], ref: List[Dict[str, np.ndarray]]) -> None:
        """One due answer (None: it never came) against its reference."""
        self.due += 1
        if ans is None:
            self.missing += 1
            self.notes.append(f"{name}: no answer")
            return
        want = [len(r["t"]) for r in ref]
        if list(ans["num_compute"]) != want:
            self.missing += 1
            self.notes.append(f"{name}: windows per band {list(ans['num_compute'])}, "
                              f"reference {want}")
            return
        tol = self.g["window_tolerance"]
        bad_t = mism = 0
        md = 0.0
        for b, r in enumerate(ref):
            n = want[b]
            dt = np.abs(ans["t"][b, :n] - r["t"]) * SECONDS_PER_DAY
            bad_t += int(np.sum(~(dt < 0.5 / self.fs)))
            md = max(md, float(np.max(np.abs(ans["mdccm"][b, :n] - r["mdccm"]), initial=0.0)))
            if not np.all(np.isfinite(ans["mdccm"][b, :n])):
                md = float("inf")
            off = _off(ans["vel"][b, :n], r["vel"], tol["vel_rel"])
            off |= _off(ans["sig_tau"][b, :n], r["sig_tau"], tol["sig_tau_rel"])
            dbaz = np.abs((ans["baz"][b, :n] - r["baz"] + 180.0) % 360.0 - 180.0)
            off |= ~(dbaz <= tol["baz_deg"]) & ~(np.isnan(ans["baz"][b, :n]) & np.isnan(r["baz"]))
            mism += int(np.sum(off))
        if bad_t:
            self.missing += 1
            self.notes.append(f"{name}: {bad_t} window times off the reference's")
            return
        self.windows += sum(want)
        self.mismatched += mism
        self.mdccm_err = max(self.mdccm_err, md)

    def numbers(self) -> Dict[str, dict]:
        """Each number compared beside its limit, the order they print in."""
        share = self.mismatched / self.windows if self.windows else 0.0
        return {
            "missing": {"value": self.missing, "limit": 0},
            "mdccm_err": {"value": self.mdccm_err, "limit": self.g["mdccm_abs"]},
            "window_share": {"value": share, "limit": self.g["window_share"]},
        }

    def correct(self) -> bool:
        n = self.numbers()
        return (self.due > 0 and self.windows > 0
                and all(v["value"] <= v["limit"] for v in n.values()))


def _off(got: np.ndarray, ref: np.ndarray, rel: float) -> np.ndarray:
    """Off by more than ``rel`` of the reference (NaN against NaN agrees)."""
    both_nan = np.isnan(got) & np.isnan(ref)
    return ~(np.abs(got - ref) <= rel * np.abs(ref)) & ~both_nan
