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
  arithmetic does to a window.  Where the reference solved by least
  trimmed squares (a configuration with ``ALPHA < 1``; its bands carry
  ``flags``), a window whose answer flags other elements is off too: the
  answer's ``stdict`` entry for the window (the 1-based elements of each
  dropped pair, reference ``plotting.py:136-137, 923-941``) has to hold
  the same multiset as the reference's dropped pairs give.  A window with
  no entry is off; an answer with no ``stdict``, or with another
  ``size`` than the array's elements, is missing.

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
        lts = [r for r in ref if "flags" in r]
        if lts:
            nchans = int(lts[0]["pairs"].max()) + 1
            if ans.get("elements") is None:
                self.missing += 1
                self.notes.append(f"{name}: no stdict (the reference's solve is LTS)")
                return
            if ans.get("size") != nchans:
                self.missing += 1
                self.notes.append(f"{name}: stdict size {ans.get('size')!r}, "
                                  f"the array {nchans} elements")
                return
        tol = self.g["window_tolerance"]
        bad_t = mism = flag_off = 0
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
            if "flags" in r:
                flags_off = _flags_off(ans["elements"][b], r["flags"], r["pairs"], nchans)
                flag_off += int(np.sum(flags_off))
                off |= flags_off
            mism += int(np.sum(off))
        if bad_t:
            self.missing += 1
            self.notes.append(f"{name}: {bad_t} window times off the reference's")
            return
        if flag_off:
            self.notes.append(f"{name}: {flag_off} of {sum(want)} windows flag other "
                              f"elements than the reference")
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


def _flags_off(got: list, flags: np.ndarray, pairs: np.ndarray, nchans: int) -> np.ndarray:
    """Per window, whether the answer's flagged elements (a list of 1-based
    element numbers, or None: no entry) differ as a multiset from those of
    the reference's dropped pairs ``flags`` (W, P)."""
    incidence = np.zeros((len(pairs), nchans + 1), dtype=np.int64)
    np.add.at(incidence, (np.arange(len(pairs)), pairs[:, 0] + 1), 1)
    np.add.at(incidence, (np.arange(len(pairs)), pairs[:, 1] + 1), 1)
    want = flags.astype(np.int64) @ incidence                    # (W, nchans + 1)
    off = np.ones(len(flags), dtype=bool)
    for w, elements in enumerate(got):
        if elements is None:
            continue
        e = np.asarray(elements, dtype=np.int64)
        if e.size and (e.min() < 1 or e.max() > nchans):
            continue
        off[w] = not np.array_equal(np.bincount(e, minlength=nchans + 1), want[w])
    return off
