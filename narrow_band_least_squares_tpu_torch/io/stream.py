"""Waveform container.

The on-host data contract of the port is the JAX package's ``ArrayStream``:
a dense ``(nchans, npts)`` float array plus sampling rate, start time and
coordinates.  This is the port's own copy (it imports nothing of the JAX
package); acquisition (``gather_waveforms``, ObsPy, FDSN, wave servers) is
not ported yet.
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
