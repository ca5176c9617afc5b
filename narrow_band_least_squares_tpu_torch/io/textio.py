"""Flat-text results persistence (the reference's checkpoint format).

The port's copy of ``narrow_band_least_squares_tpu/io/textio.py``: a TSV
with header ``Fmin Fmax Time Trace_vel Backaz MdCCM`` and one row per (band,
valid window), byte for byte what the JAX package's Python writer produces;
reading reconstructs the band list from unique Fmin values and the ragged
per-band row counts from index differences, re-packing into dense
``(nbands, vector_len)`` arrays.  The streaming monitor's resume scan keys
on these files (`models.streaming`).

``use_native=True`` (the default) writes and reads through the port's C++
codec (``native/textio.cpp``, built at first use), whose bytes are the
Python writer's; where the library cannot be built both fall back to
Python, as in the JAX package.  `codec_writes` counts the files each codec
wrote, so a caller can tell which one did.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Sequence

import numpy as np

from narrow_band_least_squares_tpu_torch import native

# files written by each codec in this process ("native", "python")
codec_writes = {"native": 0, "python": 0}
_count_lock = threading.Lock()


def _count(codec: str) -> None:
    with _count_lock:
        codec_writes[codec] += 1


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
    ``helpers.py:161-182``), through the C++ codec unless ``use_native`` is
    false, ``verbose`` is set or the library is unavailable (the same bytes
    either way).  Written atomically, to ``path + ".tmp"`` and then
    ``os.replace``: an existing .txt means a whole segment, so a process
    dying mid-write leaves at most the .tmp.
    """
    os.makedirs(save_dir or ".", exist_ok=True)
    path = os.path.join(save_dir, fname + ".txt")
    tmp = path + ".tmp"
    try:
        if use_native and not verbose and _write_native(
                tmp, vel_array, baz_array, mdccm_array, t_array, freqlist,
                num_compute_list):
            os.replace(tmp, path)
            _count("native")
            return path
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
        _count("python")
    except BaseException:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise
    return path


def _write_native(path, vel_array, baz_array, mdccm_array, t_array,
                  freqlist, num_compute_list) -> bool:
    """The C++ writer; False, with nothing written, where the library is
    unavailable, the write fails, or the inputs are not what it formats as
    ``str`` does: float64 arrays of one (nbands, width) shape holding every
    band's rows, and float band edges (``str`` of an int has no ".0")."""
    arrs = (vel_array, baz_array, mdccm_array, t_array)
    if not all(isinstance(a, np.ndarray) and a.dtype == np.float64 and a.ndim == 2
               and a.shape == vel_array.shape for a in arrs):
        return False
    if not all(isinstance(f, float) for f in freqlist):
        return False
    nc = np.ascontiguousarray(num_compute_list, dtype=np.int64)
    nbands, width = vel_array.shape
    if (nc.ndim != 1 or len(freqlist) < nc.size + 1 or nbands < nc.size
            or (nc.size and nc.max() > width)):
        return False
    lib = native.get_lib()
    if lib is None:
        return False
    vel, baz, mdccm, t = (np.ascontiguousarray(a) for a in arrs)
    fl = np.ascontiguousarray(freqlist, dtype=np.float64)
    dp = ctypes.POINTER(ctypes.c_double)
    rc = lib.nbls_write_tsv(
        path.encode(), fl.ctypes.data_as(dp), t.ctypes.data_as(dp),
        vel.ctypes.data_as(dp), baz.ctypes.data_as(dp), mdccm.ctypes.data_as(dp),
        nc.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), nc.size, width,
    )
    return rc == 0


def _read_native(path: str):
    """The C++ parse of the 6 columns: a list of 6 float64 arrays, or None
    where the library is unavailable or the parse comes up short."""
    lib = native.get_lib()
    if lib is None:
        return None
    n = lib.nbls_count_tsv_rows(path.encode())
    if n <= 0:
        return None
    cols = [np.empty(n, dtype=np.float64) for _ in range(6)]
    dp = ctypes.POINTER(ctypes.c_double)
    got = lib.nbls_read_tsv(path.encode(), *[c.ctypes.data_as(dp) for c in cols], n)
    return cols if got == n else None


def read_txtfile(save_dir: str, fname: str, use_native: bool = True):
    """Inverse of write_txtfile (reference ``helpers.py:185-235``).

    Returns ``(vel_array, baz_array, mdccm_array, t_array, freqlist,
    num_compute_list, nbands, FMIN, FMAX)``; dense arrays are
    ``(nbands, vector_len)`` with only the per-band prefix valid.  Parsed by
    the C++ codec unless ``use_native`` is false or it is unavailable.
    """
    path = os.path.join(save_dir, fname + ".txt")
    cols = _read_native(path) if use_native else None
    if cols is not None:
        temp_file = np.stack(cols, axis=1)
    else:
        temp_file = np.genfromtxt(path, skip_header=1, dtype="float")
    temp_file = np.atleast_2d(temp_file)

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
