"""Entry point ``api``: ``api.narrow_band_least_squares`` a call, with the
arguments of the port's ``examples/example.py``; the answer is the
returned tuple.

A traffic file names its entry point (``"entry"``); the harness loads
``entries/<name>.py`` and builds its ``Entry`` with the configuration, the
traffic's parameters and pool, the device, and the pipeline options (the
configuration's ``options`` and the traffic's, as keyword arguments of the
port's ``NarrowBandPipeline``; none leaves the port's defaults).

With ``ALPHA < 1`` the call's ``stdict`` is kept too, and the answer holds
for each band and valid window the sorted 1-based elements under the key
of the answer's own window time (None where the key is absent), and the
``stdict``'s ``size``.

The entry contract (`harness.spec`): ``stream(call)`` makes the call's
input from ``call.data``, ``(C, span)`` for one array and ``(A, C, span)``
for a network of A arrays (a configuration's ``arrays``, in its order);
``answer(g, deployment)`` gives a segment's answer, for a network a list of
A answers in the configuration's order, each a dict as here (None, or a
list of another length, counts every array's answer missing);
``present(g, arrived)`` is the same for one array and a network: whether
the segment's answer reached the caller.  This entry runs one array
(``traffic.lats``/``lons``).
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from portbench.reference.timeutils import stdict_timestamp_key


class Entry:
    def __init__(self, cfg: dict, params: dict, traffic, device: str, options: dict):
        from narrow_band_least_squares_tpu_torch import api
        from narrow_band_least_squares_tpu_torch.io.stream import ArrayStream

        self.api, self.ArrayStream = api, ArrayStream
        self.cfg, self.device, self.options = cfg, device, dict(options)
        self.lats, self.lons = list(traffic.lats), list(traffic.lons)
        self.freqlist, self.nbands, _ = api.get_freqlist(
            cfg["FMIN"], cfg["FMAX"], cfg["FREQ_BAND_TYPE"], cfg["NBANDS"])
        self.winlens = api.get_winlenlist(cfg["WINDOW_LENGTH_TYPE"], self.nbands,
                                          cfg["WINLEN"], cfg["WINLEN_1"], cfg["WINLEN_X"])
        fs = float(cfg["FS"])
        self.freq_resp = np.logspace(np.log10(0.01), np.log10(fs / 2),
                                     num=int(params["freq_resp_points"]))
        self.answers: Dict[int, dict] = {}
        if self.options:
            api.set_performance_defaults(**self.options)

    def stream(self, call):
        return self.ArrayStream(data=call.data, fs=float(self.cfg["FS"]),
                                start_epoch=call.start_epoch, latitudes=self.lats,
                                longitudes=self.lons)

    def __call__(self, st) -> int:
        c = self.cfg
        self.last = self.api.narrow_band_least_squares(
            self.winlens, c["WINOVER"], c["ALPHA"], st, self.lats, self.lons,
            self.nbands, None, None, self.freqlist, c["FREQ_BAND_TYPE"],
            self.freq_resp, c["FILTER_TYPE"], c["FILTER_ORDER"], c["FILTER_RIPPLE"],
            device=self.device)
        return 1

    def keep(self, g: int) -> None:
        """Keep the last call's answer for segment ``g``'s check."""
        vel, baz, mdccm, t, stdict, sig_tau, ncl = self.last[:7]
        self.answers[g] = {"vel": vel, "baz": baz, "mdccm": mdccm, "t": t,
                           "sig_tau": sig_tau, "num_compute": list(ncl)}
        if stdict is not None:
            self.answers[g]["stdict"] = stdict

    def drop(self, g: int) -> None:
        self.answers.pop(g, None)

    def answer(self, g: int, deployment) -> dict:
        """Segment ``g``'s answer; an LTS ``stdict`` read out per window
        here, after the window has closed."""
        ans = self.answers.get(g)
        if ans is not None and "stdict" in ans:
            ans = dict(ans)
            stdict = ans.pop("stdict")
            ans["size"] = stdict.get("size")
            ans["elements"] = [
                [_sorted(stdict.get(f"{b + 1:02d}_" + stdict_timestamp_key(ans["t"][b, w])))
                 for w in range(n)] for b, n in enumerate(ans["num_compute"])]
        return ans

    def present(self, g: int, arrived: set) -> bool:
        """The answer reached the caller: its call returned."""
        return g in arrived

    def route(self) -> dict:
        """The lag-search route and precision the pipeline took."""
        c = self.cfg
        plan = self.api.make_plan(self.freqlist, c["FREQ_BAND_TYPE"], self.winlens,
                                  c["WINOVER"], int(round(c["SEGMENT_S"] * c["FS"])),
                                  float(c["FS"]))
        rij = self.api.get_rij(self.lats, self.lons, len(self.lats))
        pipe = self.api._get_pipeline(
            plan, rij, filter_type=c["FILTER_TYPE"], filter_order=c["FILTER_ORDER"],
            filter_ripple=c["FILTER_RIPPLE"], alpha=c["ALPHA"], device=self.device)
        return {"xcorr_method": pipe.xcorr_method, "precision": pipe.matmul_precision}

    def free(self) -> None:
        self.api.set_performance_defaults()     # drops the cached pipelines
        self.last = None

    def disk_bytes(self) -> int:
        return 0

    def close(self) -> None:
        self.free()
        if self.options:
            self.api.set_performance_defaults(**{k: None for k in self.options})


def _sorted(elements):
    return None if elements is None else sorted(int(e) for e in elements)
