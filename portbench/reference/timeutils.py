# Frozen copy of narrow_band_least_squares_tpu_torch/utils/timeutils.py (all but
# parse_utc and datenum_to_epoch) at
# commit 3ee1e9bea504232cbf251ade8fbcb464f796f707, with its imports
# rewritten to portbench.reference.  The benchmark's yardstick: later
# changes to the port do not move it.  Edit it only with the benchmark.
"""Time conversions.

Downstream consumers of the reference expect window timestamps as matplotlib
datenums (days since 1970-01-01, matplotlib's default epoch), plotted with
``xaxis_date`` (reference ``plotting.py:91``) and, for LTS flag dictionaries,
stringified with 7 decimal places (reference ``plotting.py:923-927``).
Internally everything is POSIX epoch seconds (float).
A copy of ``narrow_band_least_squares_tpu/utils/timeutils.py``: the port
imports nothing of the JAX package, so it keeps its own.
"""

from __future__ import annotations

from typing import Union

import numpy as np

SECONDS_PER_DAY = 86400.0


def epoch_to_datenum(epoch_s: Union[float, np.ndarray]) -> Union[float, np.ndarray]:
    """POSIX epoch seconds -> matplotlib datenum (days since 1970-01-01)."""
    return np.asarray(epoch_s, dtype=np.float64) / SECONDS_PER_DAY


def stdict_timestamp_key(datenum: float) -> str:
    """Format a window datenum as an LTS flag-dictionary key.

    The reference's plotting code matches stdict keys against window times by
    rounding both to 7 decimal places (reference ``plotting.py:923-935``), so
    keys are written with exactly 7 decimals.
    """
    return format(float(datenum), ".7f")
