"""The one traffic generator: a pool of distinct segments from the seed,
and the closed loop's calls over it, as a traffic file's parameters say.

The pool is ``pool_segments`` segments of ``SEGMENT_S`` seconds, each its
own plane wave (`reference.synthetic.synthetic_plane_wave`, the frozen
generator), laid end to end in one array so that every call's stream is a
view.  The generator's keyword arguments are the traffic's ``source``, and
for each segment a value of each key of ``draw`` (uniform between the two
numbers given, from the seed, in the file's order of keys).  Call
``k`` hands over ``segments_per_call`` new segments (global indices
``k * segments_per_call + j``, the pool taken round), preceded by the
``context_segments`` before them, with a start epoch that grows with
``k``: no two calls share an epoch, so no output name repeats.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from portbench.reference.synthetic import default_array_coords, synthetic_plane_wave


@dataclass
class Call:
    """What a call hands over."""

    data: np.ndarray            # (C, (context + new) * T) view of the pool
    start_epoch: float          # of the stream's first sample
    segments: List[int]         # global indices of the new segments


class Traffic:
    def __init__(self, cfg: dict, params: dict, seed: int):
        self.cfg, self.params, self.seed = cfg, params, int(seed)
        self.fs = float(cfg["FS"])
        self.npts = int(round(cfg["SEGMENT_S"] * self.fs))
        self.n = int(params["pool_segments"])
        self.per_call = int(params["segments_per_call"])
        self.ctx = int(params.get("context_segments", 0))
        if self.n % self.per_call:
            raise ValueError("pool_segments must be a multiple of segments_per_call")
        arr = cfg["array"]
        self.lats, self.lons = default_array_coords(
            cfg["NCHANS"], arr["aperture_km"], arr["lat0"], arr["lon0"])
        rng = np.random.default_rng(np.random.SeedSequence(self.seed))
        drawn = {k: rng.uniform(lo, hi, size=self.n) for k, (lo, hi) in params["draw"].items()}
        seeds = rng.integers(0, 2 ** 63 - 1, size=self.n)
        # ring[:, T:] is the pool in order, ring[:, :T] a copy of its last
        # segment, so a segment and the one before it are one view
        T = self.npts
        self.ring = np.empty((cfg["NCHANS"], (self.n + 1) * T))
        for i in range(self.n):
            st = synthetic_plane_wave(
                nchans=cfg["NCHANS"], duration_s=cfg["SEGMENT_S"], fs=self.fs,
                aperture_km=arr["aperture_km"], seed=int(seeds[i]),
                lats=self.lats, lons=self.lons, **params["source"],
                **{k: float(v[i]) for k, v in drawn.items()})
            self.ring[:, (i + 1) * T:(i + 2) * T] = st.data
        self.ring[:, :T] = self.ring[:, self.n * T:]
        self.epoch0 = float(params["start_epoch"])

    def segment(self, g: int) -> np.ndarray:
        """Global segment ``g`` (the pool taken round), (C, T)."""
        i = g % self.n
        return self.ring[:, (i + 1) * self.npts:(i + 2) * self.npts]

    def segment_epoch(self, g: int) -> float:
        return self.epoch0 + g * self.npts / self.fs

    def context_of(self, g: int) -> Optional[np.ndarray]:
        """The samples before segment ``g`` in its call's stream that the
        reference filters through (the segment before it, where there is
        one): a causal filter's memory is far shorter than a segment."""
        g0 = (g // self.per_call) * self.per_call
        first = g0 - min(self.ctx, g0)
        return self.segment(g - 1) if g > first else None

    def call(self, k: int) -> Call:
        g0 = k * self.per_call
        ctx = min(self.ctx, g0)
        i0 = (g0 - ctx) % self.n
        T = self.npts
        span = (ctx + self.per_call) * T
        lo = (i0 + 1) * T
        if ctx and i0 == self.n - 1:
            lo = 0              # the wrap: the copy of the last segment first
        data = self.ring[:, lo:lo + span]
        if data.shape[1] != span:   # a call that runs past the pool's end
            data = np.concatenate([self.segment(g) for g in range(g0 - ctx, g0 + self.per_call)],
                                  axis=1)
        return Call(data=data, start_epoch=self.segment_epoch(g0 - ctx),
                    segments=list(range(g0, g0 + self.per_call)))
