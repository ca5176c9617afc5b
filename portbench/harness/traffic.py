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

A network of A arrays (a configuration's ``arrays``, `harness.spec.arrays_of`)
has a wave of its own for each segment and array, from its own draws and its
own seed, drawn for each (segment, array) from the seed: the pool is
``(A, C, (pool_segments + 1) T)``, and a segment, its context and a call's
data carry the arrays first.  One array draws the same numbers in the same
order as a network of one would, and keeps the ``(C, ...)`` shapes and
``lats``/``lons``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from portbench.harness.spec import arrays_of
from portbench.reference.synthetic import synthetic_plane_wave


@dataclass
class Call:
    """What a call hands over."""

    data: np.ndarray            # (C, (context + new) * T) view of the pool; (A, C, ...) a network
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
        # (name, lats, lons) an array, in the configuration's order
        self.arrays = arrays_of(cfg)
        self.network = "arrays" in cfg
        if not self.network:
            _, self.lats, self.lons = self.arrays[0]
        A = len(self.arrays)
        rng = np.random.default_rng(np.random.SeedSequence(self.seed))
        # (pool_segments, A) a key: row-major, so one array draws as before
        self.draws = {k: rng.uniform(lo, hi, size=(self.n, A))
                      for k, (lo, hi) in params["draw"].items()}
        seeds = rng.integers(0, 2 ** 63 - 1, size=(self.n, A))
        # ring[..., T:] is the pool in order, ring[..., :T] a copy of its
        # last segment, so a segment and the one before it are one view
        T = self.npts
        ring = np.empty((A, cfg["NCHANS"], (self.n + 1) * T))
        for i in range(self.n):
            for a, (_, lats, lons) in enumerate(self.arrays):
                st = synthetic_plane_wave(
                    nchans=cfg["NCHANS"], duration_s=cfg["SEGMENT_S"], fs=self.fs,
                    seed=int(seeds[i, a]), lats=lats, lons=lons, **params["source"],
                    **{k: float(v[i, a]) for k, v in self.draws.items()})
                ring[a, :, (i + 1) * T:(i + 2) * T] = st.data
        ring[..., :T] = ring[..., self.n * T:]
        self.ring = ring if self.network else ring[0]
        self.epoch0 = float(params["start_epoch"])

    def segment(self, g: int) -> np.ndarray:
        """Global segment ``g`` (the pool taken round), (C, T); (A, C, T) a
        network."""
        i = g % self.n
        return self.ring[..., (i + 1) * self.npts:(i + 2) * self.npts]

    def segment_epoch(self, g: int) -> float:
        return self.epoch0 + g * self.npts / self.fs

    def context_of(self, g: int) -> Optional[np.ndarray]:
        """The samples before segment ``g`` in its call's stream that the
        reference filters through (the segment before it, where there is
        one): a causal filter's memory is far shorter than a segment."""
        g0 = (g // self.per_call) * self.per_call
        first = g0 - min(self.ctx, g0)
        return self.segment(g - 1) if g > first else None

    def per_array(self, x: Optional[np.ndarray]) -> list:
        """A segment or context (`segment`, `context_of`) as one ``(C, T)``
        view (or None) an array, in the configuration's order."""
        if x is None:
            return [None] * len(self.arrays)
        return list(x) if self.network else [x]

    def call(self, k: int) -> Call:
        g0 = k * self.per_call
        ctx = min(self.ctx, g0)
        i0 = (g0 - ctx) % self.n
        T = self.npts
        span = (ctx + self.per_call) * T
        lo = (i0 + 1) * T
        if ctx and i0 == self.n - 1:
            lo = 0              # the wrap: the copy of the last segment first
        data = self.ring[..., lo:lo + span]
        if data.shape[-1] != span:  # a call that runs past the pool's end
            data = np.concatenate([self.segment(g) for g in range(g0 - ctx, g0 + self.per_call)],
                                  axis=-1)
        return Call(data=data, start_epoch=self.segment_epoch(g0 - ctx),
                    segments=list(range(g0, g0 + self.per_call)))
