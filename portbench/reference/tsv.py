"""Reads back what the monitor persisted for one segment, with NumPy alone:
the TSV (``Fmin Fmax Time Trace_vel Backaz MdCCM``, one row a valid
window, band after band) and its ``.npz`` sidecar (``sig_tau``).  Returns
None where the ``.txt`` is missing: an answer that never came."""

from __future__ import annotations

import os
from typing import Optional

import numpy as np


def read_segment(save_dir: str, name: str, dep) -> Optional[dict]:
    path = os.path.join(save_dir, name + ".txt")
    if not os.path.exists(path):
        return None
    rows = np.atleast_2d(np.loadtxt(path, skiprows=1, dtype=np.float64))
    B = dep.nbands
    width = max(dep.num_compute_list)
    out = {k: np.zeros((B, width)) for k in ("vel", "baz", "mdccm", "t", "sig_tau")}
    counts = []
    pos = 0
    for b in range(B):
        lo = dep.freqlist[b]
        n = 0
        while pos + n < len(rows) and abs(rows[pos + n, 0] - lo) <= 1e-12 * lo:
            n += 1
        n = min(n, width)
        for col, key in ((2, "t"), (3, "vel"), (4, "baz"), (5, "mdccm")):
            out[key][b, :n] = rows[pos:pos + n, col]
        counts.append(n)
        pos += n
    if pos != len(rows):
        counts.append(len(rows) - pos)     # rows of no band: malformed
    out["num_compute"] = counts
    npz = os.path.join(save_dir, name + ".npz")
    if os.path.exists(npz):
        with np.load(npz, allow_pickle=False) as z:
            s = np.asarray(z["sig_tau"], dtype=np.float64)
        if s.ndim == 2 and s.shape[0] == B:
            out["sig_tau"][:, :min(width, s.shape[1])] = s[:, :width]
    else:
        out["sig_tau"][:] = np.nan
    return out
