"""Entry point ``monitor``: ``StreamingMonitor.process`` a call, persisting
into a fresh directory under ``TMPDIR``; the answer is what it persisted.
The traffic's ``dispatch_segments``, ``dispatch_depth`` and ``resume``
set the monitor's batching; the pipeline options (see ``entries/api.py``)
go to the monitor as keyword arguments.
"""

from __future__ import annotations

import os
import shutil
import tempfile


class Entry:
    def __init__(self, cfg: dict, params: dict, traffic, device: str, options: dict):
        from narrow_band_least_squares_tpu_torch.io.stream import ArrayStream
        from narrow_band_least_squares_tpu_torch.models.streaming import StreamingMonitor
        from narrow_band_least_squares_tpu_torch.utils.geometry import get_rij
        from narrow_band_least_squares_tpu_torch.utils.plan import (
            get_freqlist,
            get_winlenlist,
            make_plan,
        )

        self.ArrayStream, self.cfg = ArrayStream, cfg
        self.lats, self.lons = list(traffic.lats), list(traffic.lons)
        self.epoch_of = traffic.segment_epoch
        self.params = params
        fs = float(cfg["FS"])
        freqlist, nbands, _ = get_freqlist(cfg["FMIN"], cfg["FMAX"],
                                           cfg["FREQ_BAND_TYPE"], cfg["NBANDS"])
        winlens = get_winlenlist(cfg["WINDOW_LENGTH_TYPE"], nbands, cfg["WINLEN"],
                                 cfg["WINLEN_1"], cfg["WINLEN_X"])
        plan = make_plan(freqlist, cfg["FREQ_BAND_TYPE"], winlens, cfg["WINOVER"],
                         int(round(cfg["SEGMENT_S"] * fs)), fs)
        rij = get_rij(self.lats, self.lons, len(self.lats))
        self.dir = tempfile.mkdtemp(prefix="portbench_monitor_")
        self.mon = StreamingMonitor(
            plan, rij, self.dir, freqlist, filter_type=cfg["FILTER_TYPE"],
            filter_order=cfg["FILTER_ORDER"], filter_ripple=cfg["FILTER_RIPPLE"],
            alpha=cfg["ALPHA"], dispatch_segments=int(params["dispatch_segments"]),
            device=device, **options)

    def stream(self, call):
        return self.ArrayStream(data=call.data, fs=float(self.cfg["FS"]),
                                start_epoch=call.start_epoch, latitudes=self.lats,
                                longitudes=self.lons)

    def __call__(self, st) -> int:
        recs = self.mon.process(st, resume=bool(self.params["resume"]),
                                dispatch_depth=int(self.params["dispatch_depth"]))
        return len(recs)

    def keep(self, g: int) -> None:
        """The answer is on disk already."""

    def drop(self, g: int) -> None:
        """The answer stays on disk."""

    def answer(self, g: int, deployment) -> dict:
        from portbench.reference.tsv import read_segment

        return read_segment(self.dir, self.segment_name(g), deployment)

    def present(self, g: int, arrived: set) -> bool:
        """The answer reached the caller: its .txt was persisted."""
        return os.path.exists(os.path.join(self.dir, self.segment_name(g) + ".txt"))

    def segment_name(self, g: int) -> str:
        return f"nbls_{self.epoch_of(g):.0f}"

    def route(self) -> dict:
        base = self.mon.pipe.base
        return {"xcorr_method": base.xcorr_method, "precision": base.matmul_precision}

    def disk_bytes(self) -> int:
        """What the monitor persisted, in bytes."""
        return sum(e.stat().st_size for e in os.scandir(self.dir) if e.is_file())

    def free(self) -> None:
        self.mon.close()
        self.mon = None

    def close(self) -> None:
        if self.mon is not None:
            self.free()
        shutil.rmtree(self.dir, ignore_errors=True)
