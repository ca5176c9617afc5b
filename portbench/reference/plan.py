# Frozen copy of narrow_band_least_squares_tpu_torch/utils/plan.py (the
# band edges, window lengths and window grids; the rest left out) at
# commit 3ee1e9bea504232cbf251ade8fbcb464f796f707, with its imports
# rewritten to portbench.reference.  The benchmark's yardstick: later
# changes to the port do not move it.  Edit it only with the benchmark.
"""Plan construction: frequency bands, window lengths, window grids.

Host-side, pure NumPy.  A copy of ``narrow_band_least_squares_tpu/utils/plan.py``:
the port imports nothing of the JAX package, so it keeps its own.  This module
reproduces the reference's plan semantics exactly:

- ``get_freqlist`` implements the six band-spacing schemes of reference
  ``helpers.py:8-79``, including the octave-family recomputation of NBANDS /
  FMAX and the hardcoded 2 Hz switch frequency of ``octave_linear``
  (``helpers.py:68``).
- ``get_winlenlist`` implements 'constant' and 'adaptive' window lengths
  (``helpers.py:83-104``), with the adaptive int() cast.

The window grid itself uses the contract of the vendored ``lts_array``
solver: per band, ``winlensamp = int(WINLEN_s * Fs)``, hop
``= int((1 - WINOVER) * winlensamp)``, and every fully-contained window is
computed.  Window timestamps are the **end** of each window, as epoch seconds
(converted to matplotlib datenums at the API boundary).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np


# --------------------------------------------------------------------------
# Frequency bands (reference helpers.py:8-79)
# --------------------------------------------------------------------------

def get_freqlist(FMIN: float, FMAX: float, FREQ_BAND_TYPE: str, NBANDS: int):
    """Narrow frequency band edges.  Returns (freqlist, nbands_calc, FMAX_calc).

    Mirrors reference ``helpers.py:8-79`` for all six band types.  For the
    octave family the number of bands and FMAX are recomputed from the data
    and returned (``helpers.py:42-43,53-54,63-64,76-77``).
    """
    if FREQ_BAND_TYPE == "linear":
        freqinterval = (FMAX - FMIN) / NBANDS
        freqlist = np.arange(FMIN, FMAX + freqinterval, freqinterval)
        nbands_calc, FMAX_calc = NBANDS, FMAX

    elif FREQ_BAND_TYPE == "log":
        freqlist = np.logspace(
            math.log(FMIN, 10), math.log(FMAX, 10), num=NBANDS + 1
        )
        nbands_calc, FMAX_calc = NBANDS, FMAX

    elif FREQ_BAND_TYPE == "octave":
        # upper band edge f2 = 2 * f1
        freqlist = [FMIN]
        while 2 * freqlist[-1] <= FMAX:
            freqlist.append(2 * freqlist[-1])
        nbands_calc = len(freqlist) - 1
        FMAX_calc = freqlist[-1]

    elif FREQ_BAND_TYPE == "2_octave_over":
        # two-octave bands overlapping by one octave (f2 = 4 * f1);
        # consumers index edges as (freqlist[b], freqlist[b+2])
        freqlist = [FMIN]
        while 2 * freqlist[-1] <= FMAX:
            freqlist.append(2 * freqlist[-1])
        nbands_calc = len(freqlist) - 2
        FMAX_calc = freqlist[-1]

    elif FREQ_BAND_TYPE == "onethird_octave":
        # f2 = 2^(1/3) * f1
        freqlist = [FMIN]
        while freqlist[-1] * 2 ** (1.0 / 3.0) <= FMAX:
            freqlist.append(freqlist[-1] * 2 ** (1.0 / 3.0))
        nbands_calc = len(freqlist) - 1
        FMAX_calc = freqlist[-1]

    elif FREQ_BAND_TYPE == "octave_linear":
        # octave spacing up to switch_freq, then linear up to FMAX
        switch_freq = 2
        freqlist = [FMIN]
        while 2 * freqlist[-1] <= switch_freq:
            freqlist.append(2 * freqlist[-1])
        temp_nbands = NBANDS - len(freqlist)
        freqinterval = (FMAX - freqlist[-1]) / temp_nbands
        freqlist = freqlist + list(
            np.arange(freqlist[-1], FMAX + freqinterval, freqinterval)
        )
        nbands_calc = len(freqlist) - 1
        FMAX_calc = FMAX

    else:
        raise ValueError(f"Unknown FREQ_BAND_TYPE: {FREQ_BAND_TYPE!r}")

    return list(np.asarray(freqlist, dtype=float)), nbands_calc, FMAX_calc


def band_edges(freqlist: Sequence[float], band: int, FREQ_BAND_TYPE: str) -> Tuple[float, float]:
    """Edges of one band: (f[b], f[b+2]) for '2_octave_over', else (f[b], f[b+1]).

    Matches the edge selection at reference ``narrow_band_least_squares.py:69-75``.
    """
    if FREQ_BAND_TYPE == "2_octave_over":
        return float(freqlist[band]), float(freqlist[band + 2])
    return float(freqlist[band]), float(freqlist[band + 1])


# --------------------------------------------------------------------------
# Window lengths (reference helpers.py:83-104)
# --------------------------------------------------------------------------

def get_winlenlist(
    WINDOW_LENGTH_TYPE: str, NBANDS: int, WINLEN: float,
    WINLEN_1: float, WINLEN_X: float,
) -> List[int]:
    """Per-band window lengths in seconds ('constant' or 'adaptive')."""
    if WINDOW_LENGTH_TYPE == "constant":
        return [WINLEN for _ in range(NBANDS)]
    if WINDOW_LENGTH_TYPE == "adaptive":
        # varies linearly from WINLEN_1 (lowest band) to WINLEN_X (highest),
        # cast to int like the reference (helpers.py:102)
        return [int(v) for v in np.linspace(WINLEN_1, WINLEN_X, num=NBANDS)]
    raise ValueError(f"Unknown WINDOW_LENGTH_TYPE: {WINDOW_LENGTH_TYPE!r}")


# --------------------------------------------------------------------------
# Window grids
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class WindowPlan:
    """Sliding-window grid for one band (all values static Python ints)."""

    winlen_s: float
    winlensamp: int
    hop: int
    n_windows: int
    starts: Tuple[int, ...]  # start sample of each window

    @staticmethod
    def build(winlen_s: float, winover: float, npts: int, fs: float) -> "WindowPlan":
        winlensamp = int(winlen_s * fs)
        if winlensamp < 2:
            raise ValueError(f"window of {winlen_s}s is under 2 samples at fs={fs}")
        hop = max(1, int((1.0 - winover) * winlensamp))
        starts = tuple(range(0, npts - winlensamp + 1, hop))
        if not starts:
            raise ValueError(
                f"signal of {npts} samples is shorter than one {winlensamp}-sample window"
            )
        return WindowPlan(
            winlen_s=float(winlen_s),
            winlensamp=winlensamp,
            hop=hop,
            n_windows=len(starts),
            starts=starts,
        )

    def end_times_epoch(self, start_epoch_s: float, fs: float) -> np.ndarray:
        """Window end timestamps in epoch seconds."""
        s = np.asarray(self.starts, dtype=np.float64)
        return start_epoch_s + (s + self.winlensamp) / fs
