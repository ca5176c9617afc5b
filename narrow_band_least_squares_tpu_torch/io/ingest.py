"""Streaming ingest: native miniSEED decoding + gap-tracking ring buffer.

The port's copy of ``narrow_band_least_squares_tpu/io/ingest.py``, on the
port's own native runtime (`native`, ``native/ingest.cpp``).  miniSEED (the
interchange format IRIS/IMS stations emit) is decoded in C++, samples land
in a C++ ring buffer addressed by absolute sample index, and
`StreamingIngest` hands out contiguous ``ArrayStream`` segments sized for
the monitoring plan as soon as every channel's data is complete, feeding
`models.StreamingMonitor` without staging the whole stream in Python.

The JAX package's graceful degradation is kept: without the native library
the miniSEED reader and encoder raise ``ImportError`` (quoting the
compiler's output) and the ring buffer falls back to a NumPy
implementation with the same semantics.  `RingBuffer.is_native` says which
one a ring is.
"""

from __future__ import annotations

import ctypes
import fnmatch
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from narrow_band_least_squares_tpu_torch import native as _native
from narrow_band_least_squares_tpu_torch.io.stream import ArrayStream


def _lib():
    lib = _native.get_lib()
    if lib is None:
        raise ImportError(f"native ingest runtime unavailable: {_native.build_error}")
    return lib


# ---------------------------------------------------------------------------
# miniSEED reading
# ---------------------------------------------------------------------------

@dataclass
class MSRecord:
    """One decoded miniSEED record."""

    sid: str          # "NET.STA.LOC.CHA"
    t0: float         # epoch seconds of the first sample
    fs: float
    samples: np.ndarray


def read_mseed_records(data: bytes) -> List[MSRecord]:
    """Decode a buffer of concatenated miniSEED v2 records.

    Supports encodings int16/int32/float32/float64/Steim1/Steim2, both byte
    orders, via the native decoder.  Raises ValueError on malformed input.
    """
    lib = _lib()
    buf = np.frombuffer(data, dtype=np.uint8)
    if buf.size == 0:
        return []
    nrec = ctypes.c_int64(0)
    nsamp = ctypes.c_int64(0)
    bufp = buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
    rc = lib.nbls_mseed_scan(
        bufp, buf.size, ctypes.byref(nrec), ctypes.byref(nsamp)
    )
    if rc != 0:
        raise ValueError(f"malformed miniSEED buffer (native error {rc})")
    R, S = nrec.value, nsamp.value
    if R == 0:
        return []
    sids = ctypes.create_string_buffer(R * 64)
    t0s = np.zeros(R)
    fss = np.zeros(R)
    nsamps = np.zeros(R, dtype=np.int64)
    samples = np.zeros(max(S, 1))
    dp = ctypes.POINTER(ctypes.c_double)
    ip = ctypes.POINTER(ctypes.c_int64)
    got = lib.nbls_mseed_decode(
        bufp, buf.size, sids,
        t0s.ctypes.data_as(dp), fss.ctypes.data_as(dp),
        nsamps.ctypes.data_as(ip), samples.ctypes.data_as(dp), R, max(S, 1),
    )
    if got < 0:
        raise ValueError(f"miniSEED decode failed (native error {got})")
    out: List[MSRecord] = []
    off = 0
    raw = sids.raw      # a copy of the whole buffer on every access: take it once
    for r in range(got):
        n = int(nsamps[r])
        sid = raw[r * 64 : (r + 1) * 64].split(b"\0", 1)[0].decode()
        out.append(MSRecord(sid, float(t0s[r]), float(fss[r]),
                            samples[off : off + n].copy()))
        off += n
    return out


def read_mseed(path: str) -> List[MSRecord]:
    """Decode a miniSEED file into records (native Steim1/2 decoder)."""
    with open(path, "rb") as f:
        return read_mseed_records(f.read())


def mseed_to_stream(
    records: Sequence[MSRecord],
    coordinates: Dict[str, Tuple[float, float]],
    channel_pattern: str = "*",
    fill_value: float = 0.0,
) -> ArrayStream:
    """Assemble records into an ArrayStream on a common time base.

    Channels are the sorted SIDs matching ``channel_pattern`` that have an
    entry in ``coordinates`` (sid -> (lat, lon)); the reference's example
    gets coordinates injected by ``gather_waveforms`` (example.py:92-93) — a
    miniSEED file carries none, so they are a required argument here.
    Overlaps resolve last-write-wins; gaps are filled with ``fill_value``.
    """
    by_sid: Dict[str, List[MSRecord]] = {}
    for r in records:
        if fnmatch.fnmatch(r.sid, channel_pattern) and r.sid in coordinates:
            by_sid.setdefault(r.sid, []).append(r)
    if not by_sid:
        raise ValueError(
            f"no records match pattern {channel_pattern!r} with coordinates"
        )
    sids = sorted(by_sid)
    fs = by_sid[sids[0]][0].fs
    for sid in sids:
        for r in by_sid[sid]:
            if abs(r.fs - fs) > 1e-9:
                raise ValueError(
                    f"mixed sampling rates: {r.sid} has {r.fs}, expected {fs}"
                )
    t_start = min(r.t0 for rs in by_sid.values() for r in rs)
    t_end = max(r.t0 + len(r.samples) / fs for rs in by_sid.values() for r in rs)
    npts = int(round((t_end - t_start) * fs))
    data = np.full((len(sids), npts), fill_value, dtype=np.float64)
    for c, sid in enumerate(sids):
        for r in sorted(by_sid[sid], key=lambda r: r.t0):
            i0 = int(round((r.t0 - t_start) * fs))
            n = min(len(r.samples), npts - i0)
            if n > 0:
                data[c, i0 : i0 + n] = r.samples[:n]
    return ArrayStream(
        data=data,
        fs=fs,
        start_epoch=t_start,
        latitudes=[coordinates[s][0] for s in sids],
        longitudes=[coordinates[s][1] for s in sids],
        ids=list(sids),
    )


def encode_mseed(
    sid: str,
    samples: np.ndarray,
    fs: float,
    start_epoch: float,
) -> bytes:
    """Encode one channel as Steim1 512-byte big-endian miniSEED records.

    The write-side complement of `read_mseed_records` (native codec), so
    monitoring deployments can persist raw segments in the interchange
    format stations emit.  Samples are rounded to int32 counts (raises on
    overflow — scale physical units to counts first).
    """
    lib = _lib()
    parts = (sid.split(".") + ["", "", "", ""])[:4]
    net, sta, loc, cha = parts
    x = np.ascontiguousarray(samples, dtype=np.float64)
    n = x.size
    # worst case >= 103 samples per 512-byte record (all 32-bit diffs)
    max_bytes = (n // 100 + 2) * 512
    out = np.zeros(max_bytes, dtype=np.uint8)
    dp = ctypes.POINTER(ctypes.c_double)
    up = ctypes.POINTER(ctypes.c_uint8)
    got = lib.nbls_mseed_encode(
        net.encode(), sta.encode(), loc.encode(), cha.encode(),
        float(start_epoch), float(fs),
        x.ctypes.data_as(dp), n,
        out.ctypes.data_as(up), max_bytes,
    )
    if got < 0:
        raise ValueError(f"miniSEED encode failed (native error {got})")
    return out[:got].tobytes()


def write_mseed(path: str, st: ArrayStream, scale: float = 1.0) -> int:
    """Write an ArrayStream as multiplexed Steim1 miniSEED.  Returns bytes.

    ``scale`` converts physical units to integer counts (e.g. 1e3 for
    milli-unit resolution).  Round-trips through `read_mseed` /
    `mseed_to_stream` exactly up to the count quantization.
    """
    total = 0
    with open(path, "wb") as f:
        for c, sid in enumerate(st.ids):
            buf = encode_mseed(
                sid, st.data[c] * scale, st.fs, st.start_epoch
            )
            f.write(buf)
            total += len(buf)
    return total


# ---------------------------------------------------------------------------
# Ring buffer
# ---------------------------------------------------------------------------

class RingBuffer:
    """Multi-channel gap-tracking ring buffer over absolute sample indices.

    Native (C++) when available, NumPy otherwise — identical semantics:
    `append` places samples at absolute index positions (epoch * fs),
    `ready` reports the contiguous all-channel frontier, `read` snapshots a
    block (filling gaps), `release` drops consumed data.
    """

    def __init__(self, nchans: int, capacity: int):
        self.nchans = int(nchans)
        self.capacity = int(capacity)
        self._h = None
        try:
            lib = _lib()
            h = lib.nbls_ring_create(self.nchans, self.capacity)
            if h:
                self._h = ctypes.c_void_p(h)
                self._lib = lib
        except ImportError:
            pass
        if self._h is None:  # NumPy fallback
            self._data = np.zeros((self.nchans, self.capacity))
            self._valid = np.zeros((self.nchans, self.capacity), dtype=bool)
            self._base = 0
            self._hi = 0
            self._started = False

    def __del__(self):
        h = getattr(self, "_h", None)
        if h is not None:
            self._lib.nbls_ring_destroy(h)

    # -- native-or-numpy dispatch ----------------------------------------
    def append(self, chan: int, start: int, x: np.ndarray) -> None:
        if not (isinstance(x, np.ndarray) and x.dtype == np.float64
                and x.flags.c_contiguous):
            x = np.ascontiguousarray(x, dtype=np.float64)
        if self._h is not None:
            rc = self._lib.nbls_ring_append(
                self._h, chan, start, x.ctypes.data, x.size,
            )
            if rc == -1:
                raise ValueError("bad ring append arguments")
            return
        n = x.size
        if n == 0:      # as the C++ ring: an empty block sets nothing
            return
        if not self._started:
            self._base = start          # base may be negative
            self._hi = start
            self._started = True
        end = start + n
        if start < self._base and self._hi - start <= self.capacity:
            self._base = start          # extend the window downward
        if end > self._base + self.capacity:
            new_base = end - self.capacity
            drop = min(new_base - self._base, self.capacity)
            idx = (self._base + np.arange(drop)) % self.capacity
            self._valid[:, idx] = False
            self._base = new_base
        if end <= self._base:
            return
        self._hi = max(self._hi, end)
        lo = max(start, self._base)
        idx = np.arange(lo, end) % self.capacity
        self._data[chan, idx] = x[lo - start :]
        self._valid[chan, idx] = True

    def append_batch(self, chans, starts, blocks) -> None:
        """Append many records in one native call (the telemetry feed's
        hot path — per-call Python/ctypes overhead, not the memcpy,
        bounds the monitoring loop's feed cost).  ``blocks`` is a list of
        per-record sample arrays matching ``chans``/``starts``."""
        if self._h is None or len(blocks) <= 1:
            # numpy ring, or a single record
            for c, s, x in zip(chans, starts, blocks):
                self.append(c, s, x)
            return
        # sizes must match the raveled payload exactly (len() of a 2-D
        # block would desync every subsequent record's offset)
        arrs = [np.asarray(b, dtype=np.float64).ravel() for b in blocks]
        lens = np.fromiter((a.size for a in arrs), np.int64, len(arrs))
        concat = np.concatenate(arrs)
        ch = np.asarray(chans, dtype=np.int64)
        st = np.asarray(starts, dtype=np.int64)
        got = self._lib.nbls_ring_append_batch(
            self._h, ch.ctypes.data, st.ctypes.data, lens.ctypes.data,
            concat.ctypes.data, len(blocks),
        )
        if got < 0:
            raise ValueError("bad ring append_batch arguments")

    @property
    def base(self) -> int:
        if self._h is not None:
            return int(self._lib.nbls_ring_base(self._h))
        return self._base

    def ready(self, from_idx: int) -> int:
        """Largest r with [from_idx, r) valid on every channel."""
        if self._h is not None:
            return int(self._lib.nbls_ring_ready(self._h, int(from_idx)))
        if from_idx < self._base:
            return from_idx
        i = from_idx
        hi = self._base + self.capacity
        while i < hi and bool(self._valid[:, i % self.capacity].all()):
            i += 1
        return i

    def read(self, start: int, n: int, fill: float = 0.0) -> Tuple[np.ndarray, int]:
        """((nchans, n) block, missing-sample count)."""
        out = np.zeros((self.nchans, n))
        if self._h is not None:
            missing = self._lib.nbls_ring_read(
                self._h, int(start), int(n), float(fill),
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            )
            return out, int(missing)
        idxs = start + np.arange(n)
        inwin = (idxs >= self._base) & (idxs < self._base + self.capacity)
        pos = idxs % self.capacity
        valid = np.zeros((self.nchans, n), dtype=bool)
        valid[:, inwin] = self._valid[:, pos[inwin]]
        out[:] = fill
        got = self._data[:, pos]
        out[valid] = got[valid]
        return out, int((~valid).sum())

    def release(self, idx: int) -> None:
        if self._h is not None:
            self._lib.nbls_ring_release(self._h, int(idx))
            return
        if idx <= self._base:
            return
        hi = min(idx, self._base + self.capacity)
        drop = np.arange(self._base, hi) % self.capacity
        self._valid[:, drop] = False
        self._base = idx

    @property
    def is_native(self) -> bool:
        return self._h is not None


# ---------------------------------------------------------------------------
# Streaming ingest: records -> ring -> plan-sized ArrayStream segments
# ---------------------------------------------------------------------------

class StreamingIngest:
    """Feed miniSEED bytes (or raw blocks) in; get monitor segments out.

    Args:
        channel_ids: ordered SIDs defining the array rows (must match the
            geometry used to build the pipeline).
        fs: expected sampling rate.
        segment_npts: segment length the monitoring plan was built for.
        latitudes/longitudes: per-element coordinates for emitted streams.
        halo_npts: extra trailing samples required beyond a segment before
            it is emitted (0 = emit as soon as the segment itself is whole).
        capacity_s: ring capacity in seconds (default: 4 segments).
    """

    def __init__(
        self,
        channel_ids: Sequence[str],
        fs: float,
        segment_npts: int,
        latitudes: Sequence[float],
        longitudes: Sequence[float],
        halo_npts: int = 0,
        capacity_s: Optional[float] = None,
        fill_value: float = 0.0,
        start_epoch: Optional[float] = None,
    ):
        self.ids = list(channel_ids)
        self.fs = float(fs)
        self.segment_npts = int(segment_npts)
        self.halo = int(halo_npts)
        self.lats = list(latitudes)
        self.lons = list(longitudes)
        self.fill = float(fill_value)
        cap = int((capacity_s or 4 * segment_npts / fs) * fs)
        self.ring = RingBuffer(len(self.ids), max(cap, segment_npts + self.halo))
        self._chan = {sid: i for i, sid in enumerate(self.ids)}
        # epoch of absolute index 0; set explicitly, or to the earliest
        # record of the FIRST feed batch (blocks before it are dropped)
        self._origin: Optional[float] = start_epoch
        self._cursor = 0                        # next segment start index
        self._emitted = False                   # cursor may move back until then
        self.dropped_records = 0

    # ------------------------------------------------------------------
    def feed_mseed(self, data: bytes) -> int:
        """Decode and buffer records; returns how many were accepted."""
        return self.feed_records(read_mseed_records(data))

    def feed_records(self, records: Sequence[MSRecord]) -> int:
        chan = self._chan
        fs = self.fs
        mine = [
            r for r in records
            if r.sid in chan and abs(r.fs - fs) <= 1e-9
        ]
        self.dropped_records += len(records) - len(mine)
        if self._origin is None and mine:
            self._origin = min(r.t0 for r in mine)
        origin = self._origin
        chans, starts, blocks = [], [], []
        for r in mine:
            idx = int(round((r.t0 - origin) * fs))
            if self._emitted and idx + len(r.samples) <= self._cursor - self.halo:
                self.dropped_records += 1   # entirely before consumed data
                continue
            if not self._emitted and idx < self._cursor:
                # earlier data than anything seen so far: re-anchor the
                # segment grid at it (allowed until the first emission)
                self._cursor = idx
            chans.append(chan[r.sid])
            starts.append(idx)
            blocks.append(r.samples)
        # one native call for the whole batch (order-preserving, so
        # overlap semantics stay last-write-wins)
        self.ring.append_batch(chans, starts, blocks)
        return len(blocks)

    def feed_block(self, sid: str, t0_epoch: float, samples: np.ndarray) -> None:
        """Buffer a raw sample block (e.g. from a socket feed)."""
        if sid not in self._chan:
            raise KeyError(f"unknown channel {sid!r}")
        self.feed_records(
            [MSRecord(sid, float(t0_epoch), self.fs, np.asarray(samples))]
        )

    # ------------------------------------------------------------------
    def ready_segments(self) -> Iterator[ArrayStream]:
        """Yield every complete segment the buffer can currently serve.

        A segment is emitted once all channels are contiguous through its
        end plus the halo; consumed samples are released (minus the halo
        kept for the next segment's filter warm-up)."""
        if self._origin is None:
            return
        while True:
            end = self._cursor + self.segment_npts
            if self.ring.ready(self._cursor) < end + self.halo:
                return
            block, missing = self.ring.read(
                self._cursor, self.segment_npts, self.fill
            )
            assert missing == 0
            self._emitted = True
            yield ArrayStream(
                data=block,
                fs=self.fs,
                start_epoch=self._origin + self._cursor / self.fs,
                latitudes=self.lats,
                longitudes=self.lons,
                ids=list(self.ids),
            )
            self._cursor = end
            self.ring.release(self._cursor - self.halo)
