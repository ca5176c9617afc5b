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
- ``vector_len`` reproduces the reference's dense-output width heuristic
  (``narrow_band_least_squares.py:41-47``) which treats the last band's
  window length in *seconds* as if it were samples.  Every dense output is
  ``(NBANDS, width)`` with only the prefix ``[:num_compute_list[b]]`` valid
  (the pad-and-mask contract every reference consumer relies on, e.g.
  ``plotting.py:322-326``).

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


def reference_vector_len(WINLEN_list: Sequence[float], WINOVER: float,
                         npts: int, Fs: float) -> int:
    """The reference's dense-output width heuristic.

    Reproduces ``narrow_band_least_squares.py:41-47`` including its quirk of
    treating the final band's window length in seconds as a sample increment.
    """
    max_WINLEN = WINLEN_list[-1]
    sampinc = int((1 - WINOVER) * max_WINLEN)
    nits = len(np.arange(0, npts, sampinc)) - 1
    return int(nits / Fs)


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


@dataclass(frozen=True)
class NarrowBandPlan:
    """Full static plan for a narrow-band run (hashable; jit-closure safe).

    Groups the band edges, per-band window grids and the dense-output
    bookkeeping (width / num_compute) that the pad-and-mask output contract
    requires.
    """

    freqlist: Tuple[float, ...]
    freq_band_type: str
    nbands: int
    fs: float
    npts: int
    winover: float
    winlen_list: Tuple[float, ...]
    windows: Tuple[WindowPlan, ...]
    vector_len: int          # reference heuristic width
    width: int               # actual dense width = max(vector_len, max windows)

    @property
    def num_compute_list(self) -> List[int]:
        return [w.n_windows for w in self.windows]

    @property
    def max_winlensamp(self) -> int:
        return max(w.winlensamp for w in self.windows)

    @property
    def max_windows(self) -> int:
        return max(w.n_windows for w in self.windows)

    def edges(self, band: int) -> Tuple[float, float]:
        return band_edges(self.freqlist, band, self.freq_band_type)

    def bt_products(self) -> List[float]:
        """Per-band time-bandwidth products (BT<5 draws a warning upstream,
        reference ``narrow_band_least_squares.py:82-87``)."""
        out = []
        for b in range(self.nbands):
            fmin, fmax = self.edges(b)
            out.append(self.winlen_list[b] * (fmax - fmin))
        return out


def make_plan(
    freqlist: Sequence[float],
    FREQ_BAND_TYPE: str,
    WINLEN_list: Sequence[float],
    WINOVER: float,
    npts: int,
    fs: float,
) -> NarrowBandPlan:
    if FREQ_BAND_TYPE == "2_octave_over":
        nbands = len(freqlist) - 2
    else:
        nbands = len(freqlist) - 1
    if len(WINLEN_list) != nbands:
        raise ValueError(
            f"WINLEN_list has {len(WINLEN_list)} entries but there are {nbands} bands"
        )
    windows = tuple(
        WindowPlan.build(WINLEN_list[b], WINOVER, npts, fs) for b in range(nbands)
    )
    vec_len = reference_vector_len(WINLEN_list, WINOVER, npts, fs)
    width = max(vec_len, max(w.n_windows for w in windows))
    return NarrowBandPlan(
        freqlist=tuple(float(f) for f in freqlist),
        freq_band_type=FREQ_BAND_TYPE,
        nbands=nbands,
        fs=float(fs),
        npts=int(npts),
        winover=float(WINOVER),
        winlen_list=tuple(float(w) for w in WINLEN_list),
        windows=windows,
        vector_len=vec_len,
        width=width,
    )
