"""Flat-text results persistence (the reference's checkpoint format).

The port's copy of ``narrow_band_least_squares_tpu/io/textio.py``, Python
codec only: a TSV with header ``Fmin Fmax Time Trace_vel Backaz MdCCM`` and
one row per (band, valid window), byte for byte what the JAX package's
Python writer produces; reading reconstructs the band list from unique Fmin
values and the ragged per-band row counts from index differences,
re-packing into dense ``(nbands, vector_len)`` arrays.  The streaming
monitor's resume scan keys on these files (`models.streaming`).

The JAX package also carries a C++ codec with the same bytes; the port has
none yet (ROADMAP.md, Queue 1), so ``use_native`` is accepted and changes
nothing.
"""

from __future__ import annotations

import os
from typing import Sequence

import numpy as np


def write_txtfile(
    save_dir: str,
    fname: str,
    vel_array: np.ndarray,
    baz_array: np.ndarray,
    mdccm_array: np.ndarray,
    t_array: np.ndarray,
    freqlist: Sequence[float],
    num_compute_list: Sequence[int],
    verbose: bool = False,
    use_native: bool = True,
) -> str:
    """Write results as TSV; returns the path written.

    Header line, then ``num_compute_list[b]`` rows per band of
    ``Fmin Fmax Time Trace_vel Backaz MdCCM`` (reference
    ``helpers.py:161-182``).  Written atomically, to ``path + ".tmp"`` and
    then ``os.replace``: an existing .txt means a whole segment, so a
    process dying mid-write leaves at most the .tmp.  ``use_native`` is
    kept for signature parity (module docstring).
    """
    del use_native
    os.makedirs(save_dir or ".", exist_ok=True)
    path = os.path.join(save_dir, fname + ".txt")
    tmp = path + ".tmp"
    try:
        with open(tmp, "w") as f:
            f.write("Fmin \t Fmax \t Time \t Trace_vel \t Backaz \t MdCCM \n")
            for ii in range(len(num_compute_list)):
                if verbose:
                    print(num_compute_list[ii])
                for jj in range(int(num_compute_list[ii])):
                    f.write(
                        str(freqlist[ii]) + "\t" + str(freqlist[ii + 1]) + "\t"
                        + str(t_array[ii, jj]) + "\t" + str(vel_array[ii, jj])
                        + "\t" + str(baz_array[ii, jj]) + "\t"
                        + str(mdccm_array[ii, jj]) + "\n"
                    )
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise
    return path


def read_txtfile(save_dir: str, fname: str, use_native: bool = True):
    """Inverse of write_txtfile (reference ``helpers.py:185-235``).

    Returns ``(vel_array, baz_array, mdccm_array, t_array, freqlist,
    num_compute_list, nbands, FMIN, FMAX)``; dense arrays are
    ``(nbands, vector_len)`` with only the per-band prefix valid.
    ``use_native`` is kept for signature parity (module docstring).
    """
    del use_native
    path = os.path.join(save_dir, fname + ".txt")
    temp_file = np.atleast_2d(np.genfromtxt(path, skip_header=1, dtype="float"))

    fmin_list = temp_file[:, 0]
    fmax_temp = temp_file[-1, 1]
    unique_freq, idx = np.unique(fmin_list, return_index=True)
    freqlist = np.append(unique_freq, fmax_temp)
    idx = np.append(idx, len(fmin_list))
    num_compute_list = np.diff(idx)
    FMIN = fmin_list[0]
    FMAX = fmax_temp

    # vector_len recovered from the final band's row count (helpers.py:212)
    vector_len = len(fmin_list) - idx[-2]
    nbands = len(freqlist) - 1
    vel_array = np.zeros((nbands, vector_len))
    baz_array = np.zeros((nbands, vector_len))
    mdccm_array = np.zeros((nbands, vector_len))
    t_array = np.zeros((nbands, vector_len))

    t_list = temp_file[:, 2]
    vel_list = temp_file[:, 3]
    baz_list = temp_file[:, 4]
    mdccm_list = temp_file[:, 5]

    for ii in range(nbands):
        a, b = idx[ii], idx[ii + 1]
        n = b - a
        vel_array[ii, :n] = vel_list[a:b]
        baz_array[ii, :n] = baz_list[a:b]
        mdccm_array[ii, :n] = mdccm_list[a:b]
        t_array[ii, :n] = t_list[a:b]

    return (
        vel_array, baz_array, mdccm_array, t_array,
        freqlist, num_compute_list, nbands, FMIN, FMAX,
    )
