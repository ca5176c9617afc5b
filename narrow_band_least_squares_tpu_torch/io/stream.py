"""Waveform container.

The on-host data contract of the port is the JAX package's ``ArrayStream``:
a dense ``(nchans, npts)`` float array plus sampling rate, start time and
coordinates.  This is the port's own copy (it imports nothing of the JAX
package), with its ObsPy-style indexing (``len(st)``, ``st[i].data``,
``st[i].times()``) and ``from_obspy`` bridge; acquisition
(``gather_waveforms``, FDSN, wave servers) is not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import List

import numpy as np

from narrow_band_least_squares_tpu_torch.utils.timeutils import epoch_to_datenum


@dataclass
class ArrayStream:
    """Waveforms from one infrasound array on a common time base.

    Attributes:
        data: ``(nchans, npts)`` float64 array, one row per element [Pa].
        fs: sampling rate [Hz].
        start_epoch: POSIX epoch seconds of sample 0 (UTC).
        latitudes / longitudes: per-element coordinates [deg].
        ids: per-element channel identifiers (e.g. 'IM.I53H1..BDF').
    """

    data: np.ndarray
    fs: float
    start_epoch: float
    latitudes: List[float]
    longitudes: List[float]
    ids: List[str] = field(default_factory=list)

    def __post_init__(self):
        self.data = np.atleast_2d(np.asarray(self.data, dtype=np.float64))
        if not self.ids:
            self.ids = [f"CH{i}" for i in range(self.nchans)]
        if len(self.latitudes) != self.nchans or len(self.longitudes) != self.nchans:
            raise ValueError(
                f"coordinate lists ({len(self.latitudes)}, {len(self.longitudes)}) "
                f"do not match nchans={self.nchans}"
            )

    @property
    def nchans(self) -> int:
        return self.data.shape[0]

    @property
    def npts(self) -> int:
        return self.data.shape[1]

    @property
    def duration(self) -> float:
        return self.npts / self.fs

    def times_epoch(self) -> np.ndarray:
        return self.start_epoch + np.arange(self.npts) / self.fs

    def times_matplotlib(self) -> np.ndarray:
        return epoch_to_datenum(self.times_epoch())

    def copy(self) -> "ArrayStream":
        return replace(
            self,
            data=self.data.copy(),
            latitudes=list(self.latitudes),
            longitudes=list(self.longitudes),
            ids=list(self.ids),
        )

    def slice_samples(self, i0: int, i1: int) -> "ArrayStream":
        out = self.copy()
        out.data = self.data[:, i0:i1].copy()
        out.start_epoch = self.start_epoch + i0 / self.fs
        return out

    # -- compatibility with ObsPy-style indexing used by plotting --------
    def __len__(self) -> int:
        return self.nchans

    def __getitem__(self, i: int) -> "_TraceView":
        return _TraceView(self, i)

    # -- ObsPy bridge ----------------------------------------------------
    @classmethod
    def from_obspy(cls, st) -> "ArrayStream":
        """Build from an ObsPy Stream whose traces carry .stats.latitude/longitude."""
        npts = min(tr.stats.npts for tr in st)
        data = np.stack([np.asarray(tr.data[:npts], dtype=np.float64) for tr in st])
        return cls(
            data=data,
            fs=float(st[0].stats.sampling_rate),
            start_epoch=float(st[0].stats.starttime.timestamp),
            latitudes=[float(tr.stats.latitude) for tr in st],
            longitudes=[float(tr.stats.longitude) for tr in st],
            ids=[tr.id for tr in st],
        )

    def save_npz(self, path: str) -> None:
        np.savez_compressed(
            path,
            data=self.data,
            fs=self.fs,
            start_epoch=self.start_epoch,
            latitudes=np.asarray(self.latitudes),
            longitudes=np.asarray(self.longitudes),
            ids=np.asarray(self.ids),
        )

    @classmethod
    def load_npz(cls, path: str) -> "ArrayStream":
        z = np.load(path, allow_pickle=False)
        return cls(
            data=z["data"],
            fs=float(z["fs"]),
            start_epoch=float(z["start_epoch"]),
            latitudes=[float(v) for v in z["latitudes"]],
            longitudes=[float(v) for v in z["longitudes"]],
            ids=[str(v) for v in z["ids"]],
        )


class _TraceView:
    """Minimal ObsPy-Trace-like view so plotting code can do st[0].times()."""

    def __init__(self, stream: ArrayStream, idx: int):
        self._stream = stream
        self._idx = idx

    @property
    def data(self) -> np.ndarray:
        return self._stream.data[self._idx]

    def times(self, kind: str = "matplotlib") -> np.ndarray:
        if kind == "matplotlib":
            return self._stream.times_matplotlib()
        if kind == "epoch":
            return self._stream.times_epoch()
        return np.arange(self._stream.npts) / self._stream.fs

    def __array__(self, dtype=None, copy=None):
        return np.asarray(self.data, dtype=dtype)

    def __len__(self) -> int:
        return self._stream.npts
