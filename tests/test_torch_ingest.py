"""PyTorch port: streaming ingest (`io.ingest`) against the JAX package.

Mirrors ``tests/test_ingest.py`` case by case, and runs the JAX function
and the port's on the same bytes and feeds: decoded records (SID, start,
rate, samples), segments, ring reads and encoded bytes must be equal
exactly, error outcomes the same ``ValueError``; the monitor fed by the
port's ingest agrees with the one fed by the JAX package's within 1e-4.

The miniSEED record makers come from ``tests/test_ingest.py`` (packed with
``struct`` straight from the SEED v2 spec, independent of either decoder).
Importing that module carries over its module-level skip when the JAX
package's native library cannot be built; this box has ``g++``, so it is
built and nothing skips.
"""

import math
import struct

import numpy as np
import pytest

from narrow_band_least_squares_tpu.io import ingest as J
from narrow_band_least_squares_tpu.io.stream import ArrayStream as JStream
from narrow_band_least_squares_tpu.io.synthetic import synthetic_plane_wave
from narrow_band_least_squares_tpu.models.streaming import StreamingMonitor as JMonitor
from narrow_band_least_squares_tpu.utils.geometry import get_rij
from narrow_band_least_squares_tpu.utils.plan import get_freqlist, get_winlenlist, make_plan
from narrow_band_least_squares_tpu_torch.io import ingest as T
from narrow_band_least_squares_tpu_torch.io.stream import ArrayStream as TStream
from narrow_band_least_squares_tpu_torch.models import StreamingMonitor
from narrow_band_least_squares_tpu_torch.utils import plan as tplan

from test_ingest import _epoch, _header, make_int32_record, make_steim1_record

TOL = 1e-4
COORDS = {"IM.I53H1..BDF": (64.0, -147.0), "IM.I53H2..BDF": (64.001, -147.001)}


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def make_record(samples, encoding, big=True, reclen=512, **kw):
    """One record of int16 (1), int32 (3), float32 (4) or float64 (5)."""
    fmt = {1: "h", 3: "i", 4: "f", 5: "d"}[encoding]
    e = ">" if big else "<"
    rec = bytearray(reclen)
    rec[:64] = _header(kw.pop("net", "IM"), kw.pop("sta", "I53H1"), "", "BDF",
                       2018, 353, 1, 45, kw.pop("ss", 0), kw.pop("fract", 0),
                       len(samples), 20, encoding, reclen, big)
    struct.pack_into(e + f"{len(samples)}{fmt}", rec, 64, *samples)
    return bytes(rec)


def steim2_record():
    """``tests/test_ingest.py``'s hand-built Steim2 frame (every dnib
    variant) and its samples."""
    x0 = 1000
    groups = [(3, 1, 5, [0, -2, 3, -4, 5, -6]), (2, 3, 10, [400, -500, 120]),
              (2, 2, 15, [16000, -16000]), (1, None, 8, [1, -1, 100, -100]),
              (3, 0, 6, [31, -31, 5, -5, 0]), (3, 2, 4, [7, -8, 1, -1, 2, -2, 3]),
              (2, 1, 30, [2 ** 29 - 1])]
    diffs = [d for g in groups for d in g[3]]
    samples = [x0]
    for d in diffs[1:]:
        samples.append(samples[-1] + d)
    words, cks = [0] * 16, [0] * 16
    words[1], words[2] = x0, samples[-1] & 0xFFFFFFFF
    for w, (ck, dnib, bits, vals) in enumerate(groups, start=3):
        if dnib is None:
            v = struct.unpack(">I", struct.pack(">4b", *vals))[0]
        else:
            v, shift = dnib << 30, bits * (len(vals) - 1)
            for x in vals:
                v |= (x & ((1 << bits) - 1)) << shift
                shift -= bits
        words[w], cks[w] = v, ck
    words[0] = sum(c << (2 * (15 - i)) for i, c in enumerate(cks))
    rec = bytearray(128)
    rec[:64] = _header("IM", "I53H1", "", "BDF", 2018, 353, 1, 45, 0, 0,
                       len(samples), 20, 11, 128, True)
    for i, wv in enumerate(words):
        struct.pack_into(">I", rec, 64 + 4 * i, wv)
    return bytes(rec), samples


def outcome(mod, buf):
    """The records a decoder returns, or its ValueError's message."""
    try:
        return [(r.sid, r.t0, r.fs, r.samples.tobytes()) for r in mod.read_mseed_records(buf)]
    except ValueError as e:
        return f"ValueError: {e}"


def assert_same_decode(buf):
    got, want = outcome(T, buf), outcome(J, buf)
    assert got == want
    return got


# ---------------------------------------------------------------------------
# miniSEED decoding
# ---------------------------------------------------------------------------

STEIM1 = np.cumsum(np.concatenate([
    np.random.default_rng(11).integers(-100, 100, 40),
    np.random.default_rng(12).integers(-30000, 30000, 10),
    np.random.default_rng(13).integers(-2 ** 28, 2 ** 28, 5),
    np.random.default_rng(14).integers(-5, 5, 45)])).astype(np.int64)

CASES = {
    "int32-big": lambda: make_int32_record(list(range(-50, 50))),
    "int32-little": lambda: make_int32_record([2 ** 30, -(2 ** 30), 7, -7], big=False),
    "int16-big": lambda: make_record(list(range(-300, 300, 7)), 1),
    "int16-little": lambda: make_record([-32768, 32767, 0, 5], 1, big=False),
    "float32-big": lambda: make_record([0.5, -1.25, 3.0e7, 1e-3], 4),
    "float32-little": lambda: make_record([0.5, -1.25, 3.0e7, 1e-3], 4, big=False),
    "float64-big": lambda: make_record([math.pi, -1e300, 2.5e-10], 5),
    "float64-little": lambda: make_record([math.pi, -1e300, 2.5e-10], 5, big=False),
    "fractional-start": lambda: make_int32_record([1, 2, 3], fract=1234),
    "concatenated": lambda: (make_int32_record([1, 2, 3], sta="I53H1")
                             + make_int32_record([4, 5], sta="I53H2", mm=46)),
    "steim1": lambda: make_steim1_record(list(STEIM1)),
    "steim2": lambda: steim2_record()[0],
    "malformed": lambda: b"\x00" * 256,
    "empty": lambda: b"",
}


@pytest.mark.parametrize("case", list(CASES))
def test_decode_matches_jax(case):
    got = assert_same_decode(CASES[case]())
    if case == "malformed":
        assert got.startswith("ValueError")
    elif case != "empty":
        assert got and not isinstance(got, str)


def test_decode_known_answers():
    """The JAX tests' known answers, on the port's decoder."""
    t0 = _epoch(2018, 353, 1, 45, 0)
    r = T.read_mseed_records(make_int32_record(list(range(-50, 50))))[0]
    assert (r.sid, r.fs) == ("IM.I53H1..BDF", 20.0)
    assert r.t0 == pytest.approx(t0, abs=1e-6)
    np.testing.assert_array_equal(r.samples, np.arange(-50, 50))
    r = T.read_mseed_records(make_int32_record([1, 2, 3], fract=1234))[0]
    assert r.t0 == pytest.approx(t0 + 0.1234, abs=1e-7)
    np.testing.assert_array_equal(
        T.read_mseed_records(make_steim1_record(list(STEIM1)))[0].samples, STEIM1)
    buf, samples = steim2_record()
    np.testing.assert_array_equal(T.read_mseed_records(buf)[0].samples, samples)
    with pytest.raises(ValueError, match="malformed"):
        T.read_mseed_records(b"\x00" * 256)


@pytest.mark.parametrize("kind", ["int32", "steim1"])
def test_mutation_sweep_same_outcome_as_jax(kind):
    """Every seeded single-byte mutation and truncation of a valid record:
    the port's decoder returns the JAX decoder's records or raises its
    ValueError, and never crashes."""
    base = bytearray(make_int32_record(list(range(100))) if kind == "int32"
                     else make_steim1_record(list(STEIM1)))
    rng = np.random.default_rng(0 if kind == "int32" else 1)
    raised = 0
    for _ in range(300):
        buf = bytearray(base)
        buf[int(rng.integers(0, len(buf)))] = int(rng.integers(0, 256))
        raised += isinstance(assert_same_decode(bytes(buf)), str)
    for cut in range(1, 256, 17):
        assert_same_decode(bytes(base[:-cut]))
    assert 0 < raised < 300


def test_read_mseed_file(tmp_path):
    p = tmp_path / "x.mseed"
    p.write_bytes(CASES["concatenated"]())
    got = [(r.sid, r.t0, r.samples.tolist()) for r in T.read_mseed(str(p))]
    assert got == [(r.sid, r.t0, r.samples.tolist()) for r in J.read_mseed(str(p))]


# ---------------------------------------------------------------------------
# stream assembly
# ---------------------------------------------------------------------------

def _streams_equal(a, b):
    np.testing.assert_array_equal(a.data, b.data)
    assert (a.fs, a.start_epoch, a.ids) == (b.fs, b.start_epoch, b.ids)
    assert (list(a.latitudes), list(a.longitudes)) == (list(b.latitudes), list(b.longitudes))


def test_mseed_to_stream_gap_pattern_and_overlap():
    """``test_ingest.py``'s gap and pattern case, plus an overlap (last
    write wins) and a record out of time order."""
    buf = (make_int32_record(list(range(100)), sta="I53H1")
           + make_int32_record(list(range(100)), sta="I53H2")
           + make_int32_record(list(range(100, 200)), sta="I53H1", ss=10)
           + make_int32_record(list(range(10)), sta="XXXXX", cha="BHZ")
           + make_int32_record([-7] * 40, sta="I53H2", ss=2))
    kw = dict(channel_pattern="IM.*.BDF", fill_value=-1.0)
    got = T.mseed_to_stream(T.read_mseed_records(buf), COORDS, **kw)
    want = J.mseed_to_stream(J.read_mseed_records(buf), COORDS, **kw)
    _streams_equal(got, want)
    assert (got.nchans, got.npts) == (2, 300)
    np.testing.assert_array_equal(got.data[0, 100:200], -1.0)
    np.testing.assert_array_equal(got.data[1, 40:80], -7.0)


def test_mseed_to_stream_refusals():
    mixed = T.read_mseed_records(make_int32_record([1, 2], sta="I53H1")) + [
        T.MSRecord("IM.I53H2..BDF", 0.0, 40.0, np.ones(3))]
    jmixed = [J.MSRecord(r.sid, r.t0, r.fs, r.samples) for r in mixed]
    for mod, recs in ((T, mixed), (J, jmixed)):
        with pytest.raises(ValueError, match="mixed sampling rates"):
            mod.mseed_to_stream(recs, COORDS)
        with pytest.raises(ValueError, match="no records match"):
            mod.mseed_to_stream(recs, COORDS, channel_pattern="XX.*")


# ---------------------------------------------------------------------------
# the encoder
# ---------------------------------------------------------------------------

def test_encoder_bytes_equal_jax_and_round_trip():
    rng = np.random.default_rng(0)
    x = np.concatenate([
        rng.integers(-2**30, 2**30, size=50).astype(float),
        np.cumsum(rng.integers(-100, 100, size=500)).astype(float),
        np.zeros(37),
        np.cumsum(rng.integers(-30000, 30000, size=300)).astype(float),
        rng.normal(scale=50.0, size=200),          # rounded to counts
    ])
    got = T.encode_mseed("IM.I53H1..BDF", x, 20.0, 1545183900.25)
    assert got == J.encode_mseed("IM.I53H1..BDF", x, 20.0, 1545183900.25)
    recs = T.read_mseed_records(got)
    np.testing.assert_array_equal(np.concatenate([r.samples for r in recs]),
                                  np.round(x))
    n = 0
    for r in recs:
        assert abs(r.t0 - (1545183900.25 + n / 20.0)) < 1e-4
        n += len(r.samples)


def test_write_mseed_equals_jax(tmp_path):
    rng = np.random.default_rng(1)
    kw = dict(data=np.round(rng.normal(scale=1000, size=(3, 1000))), fs=20.0,
              start_epoch=1545183900.0, latitudes=[64.1, 64.2, 64.3],
              longitudes=[-147.1, -147.2, -147.3],
              ids=["IM.A..BDF", "IM.B..BDF", "IM.C..BDF"])
    pt, pj = tmp_path / "t.mseed", tmp_path / "j.mseed"
    assert T.write_mseed(str(pt), TStream(**kw), scale=2.0) == \
        J.write_mseed(str(pj), JStream(**kw), scale=2.0)
    assert pt.read_bytes() == pj.read_bytes()
    coords = {s: (la, lo) for s, la, lo in zip(kw["ids"], kw["latitudes"], kw["longitudes"])}
    st = T.mseed_to_stream(T.read_mseed(str(pt)), coords)
    np.testing.assert_array_equal(st.data, kw["data"] * 2.0)


def test_encoder_refuses_overflow():
    for mod in (T, J):
        with pytest.raises(ValueError, match="-42"):
            mod.encode_mseed("IM.A..BDF", np.array([3e9]), 20.0, 0.0)


# ---------------------------------------------------------------------------
# the ring buffer
# ---------------------------------------------------------------------------

def _ring_ops(seed, nchans=3, cap=64, n=400):
    """A seeded random sequence of ring operations: appends (some below
    the window, some overlapping, some past it), batches, ready, read,
    release."""
    rng = np.random.default_rng(seed)
    ops, hi = [], 0
    for _ in range(n):
        k = rng.integers(0, 10)
        if k < 4:
            start = int(hi + rng.integers(-40, 20))
            x = rng.normal(size=int(rng.integers(0, 30)))
            ops.append(("append", int(rng.integers(0, nchans)), start, x))
            hi = max(hi, start + x.size)
        elif k < 5:
            m = int(rng.integers(1, 5))
            chans = rng.integers(0, nchans, m).tolist()
            starts = (hi + rng.integers(-30, 10, m)).tolist()
            blocks = [rng.normal(size=int(rng.integers(1, 20))) for _ in range(m)]
            ops.append(("batch", chans, starts, blocks))
            hi = max([hi] + [s + b.size for s, b in zip(starts, blocks)])
        elif k < 7:
            ops.append(("ready", int(hi + rng.integers(-80, 5))))
        elif k < 9:
            ops.append(("read", int(hi + rng.integers(-90, 0)), int(rng.integers(0, 70)),
                        float(rng.normal())))
        else:
            ops.append(("release", int(hi + rng.integers(-70, 0))))
    return ops


def _play(ring, ops):
    out = []
    for op in ops:
        if op[0] == "append":
            ring.append(op[1], op[2], op[3])
        elif op[0] == "batch":
            ring.append_batch(op[1], op[2], op[3])
        elif op[0] == "ready":
            out.append(ring.ready(op[1]))
        elif op[0] == "read":
            block, missing = ring.read(op[1], op[2], op[3])
            out.append((block.tobytes(), missing))
        else:
            ring.release(op[1])
        out.append(ring.base)
    return out


def _ring(nchans, cap, native_ring, monkeypatch):
    """The port's ring, native or (without the library) NumPy."""
    if not native_ring:
        monkeypatch.setattr(T._native, "get_lib", lambda: None)
    return T.RingBuffer(nchans, cap)


@pytest.mark.parametrize("native_ring", [True, False], ids=["native", "numpy"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ring_matches_jax_ring(native_ring, seed, monkeypatch):
    ops = _ring_ops(seed)
    ring = _ring(3, 64, native_ring, monkeypatch)
    assert ring.is_native == native_ring
    want = J.RingBuffer(3, 64)
    assert want.is_native
    assert _play(ring, ops) == _play(want, ops)


@pytest.mark.parametrize("native_ring", [True, False], ids=["native", "numpy"])
def test_ring_semantics(native_ring, monkeypatch):
    """``test_ingest.py``'s ring cases: frontier, gap fill, wrap-around and
    window advance, release, last write wins."""
    rb = _ring(2, 100, native_ring, monkeypatch)
    assert rb.is_native == native_ring
    rb.append(0, 0, np.ones(30))
    assert rb.ready(0) == 0
    rb.append(1, 0, np.ones(10))
    assert rb.ready(0) == 10
    rb.append(1, 20, np.full(20, 3.0))
    out, missing = rb.read(0, 40, fill=-9.0)
    assert missing == 10 + 10               # ch0 tail, ch1 gap
    np.testing.assert_array_equal(out[1, 10:20], -9.0)
    rb.append(1, 10, np.full(20, 5.0))       # overlaps: last write wins
    np.testing.assert_array_equal(rb.read(0, 40)[0][1, 10:30], 5.0)
    rb.append(0, 150, np.arange(20.0))       # advances the window to 70
    assert rb.base == 70
    assert rb.read(0, 30)[1] == 60
    rb.release(160)
    assert rb.base == 160
    np.testing.assert_array_equal(rb.read(160, 10)[0][0], np.arange(10.0, 20.0))


# ---------------------------------------------------------------------------
# streaming ingest
# ---------------------------------------------------------------------------

IDS = list(COORDS)


def _ingest(mod, halo=0, seg=200):
    return mod.StreamingIngest(IDS, fs=20.0, segment_npts=seg,
                               latitudes=[64.0, 64.001], longitudes=[-147.0, -147.001],
                               halo_npts=halo)


def _drive(mod, feed, halo=0, seg=200, drain_each=True):
    """Feed ``feed`` (batches of (sid, t0, samples)) into ``mod``'s ingest,
    draining ready segments after each batch (or only at the end)."""
    ing = _ingest(mod, halo, seg)
    segs = []
    for batch in feed:
        ing.feed_records([mod.MSRecord(sid, t0, 20.0, x) for sid, t0, x in batch])
        if drain_each:
            segs.extend(ing.ready_segments())
    segs.extend(ing.ready_segments())
    return ing, segs


def _same_segments(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        _streams_equal(a, b)


def test_shuffled_blocks_assemble():
    t0 = _epoch(2018, 353, 1, 45, 0)
    rng = np.random.default_rng(0)
    x = {sid: rng.standard_normal(500) for sid in IDS}
    blocks = [(sid, k) for sid in IDS for k in range(5)]
    rng.shuffle(blocks)
    feed = [[(sid, t0 + k * 5.0, x[sid][k * 100:(k + 1) * 100])] for sid, k in blocks]
    ing, segs = _drive(T, feed, drain_each=False)
    _same_segments(segs, _drive(J, feed, drain_each=False)[1])
    assert len(segs) == 2 and ing.ring.is_native
    for s, seg in enumerate(segs):
        assert seg.start_epoch == pytest.approx(t0 + s * 10.0)
        for c, sid in enumerate(IDS):
            np.testing.assert_array_equal(seg.data[c], x[sid][s * 200:(s + 1) * 200])


def test_interleaved_feed_and_emit():
    t0 = _epoch(2018, 353, 1, 45, 0)
    rng = np.random.default_rng(1)
    x = {sid: rng.standard_normal(600) for sid in IDS}
    feed = []
    for k in range(6):      # channel 2 lags one block behind channel 1
        feed.append([(IDS[0], t0 + k * 5.0, x[IDS[0]][k * 100:(k + 1) * 100])])
        if k:
            feed.append([(IDS[1], t0 + (k - 1) * 5.0, x[IDS[1]][(k - 1) * 100:k * 100])])
    feed.append([(IDS[1], t0 + 25.0, x[IDS[1]][500:600])])
    _, segs = _drive(T, feed)
    _same_segments(segs, _drive(J, feed)[1])
    assert len(segs) == 3


def test_halo_delays_emission():
    for mod in (T, J):
        ing = _ingest(mod, halo=50)
        for sid in IDS:
            ing.feed_block(sid, 1545183900.0, np.ones(200))
        assert list(ing.ready_segments()) == []
        for sid in IDS:
            ing.feed_block(sid, 1545183910.0, np.ones(50))
        assert len(list(ing.ready_segments())) == 1
        with pytest.raises(KeyError):
            ing.feed_block("XX.NOPE..BHZ", 0.0, np.ones(3))


def test_foreign_records_dropped():
    for mod in (T, J):
        ing = _ingest(mod)
        ing.feed_records([mod.MSRecord("XX.FOO..BHZ", 0.0, 20.0, np.ones(10)),
                          mod.MSRecord(IDS[0], 0.0, 40.0, np.ones(10))])
        assert ing.dropped_records == 2


def test_jittered_feed_same_segments_and_drops_as_jax():
    """One jittered feed: records in random order within a sliding window,
    overlapping re-sends, a late first batch that moves the cursor back
    before the first emission, and stragglers after it (dropped).  The
    port's segments and ``dropped_records`` equal JAX's, at halo 0 and 30."""
    rng = np.random.default_rng(3)
    t0 = 1545183900.0
    n, rec = 3000, 40
    x = {sid: np.round(rng.normal(scale=100, size=n)) for sid in IDS}
    items = [(sid, k) for k in range(0, n, rec) for sid in IDS]
    keys = np.arange(len(items)) + rng.integers(0, 12, len(items))
    order = [items[i] for i in np.argsort(keys, kind="stable")]
    order = order[4:6] + order[:4] + order[6:]      # a later record arrives first
    order += [(IDS[0], k) for k in (0, 40, 1200)]    # stragglers and a re-send
    feed, i = [], 0
    while i < len(order):
        m = int(rng.integers(1, 7))
        feed.append([(sid, t0 + k / 20.0, x[sid][k:k + rec]) for sid, k in order[i:i + m]])
        i += m
    for halo in (0, 30):
        ti, tsegs = _drive(T, feed, halo)
        ji, jsegs = _drive(J, feed, halo)
        _same_segments(tsegs, jsegs)
        assert ti.dropped_records == ji.dropped_records > 0
        assert len(tsegs) >= 12
        for s, seg in enumerate(tsegs):
            i0 = int(round((seg.start_epoch - t0) * 20.0))
            for c, sid in enumerate(IDS):
                np.testing.assert_array_equal(seg.data[c], x[sid][i0:i0 + 200])


# ---------------------------------------------------------------------------
# miniSEED -> ingest -> monitor
# ---------------------------------------------------------------------------

def feed_monitor(mod, records, mon, packet=8):
    """Records in arrival order, ``packet`` at a time, into ``mod``'s
    ingest; each ready segment is submitted with the segment before it, so
    the monitor cuts its filter halo from real data (that segment is
    already queued or persisted and is skipped).  Returns (ingest, the
    segments emitted, the monitor's records)."""
    ids = sorted({r.sid for r in records})
    ing = mod.StreamingIngest(ids, fs=records[0].fs, segment_npts=mon.plan.npts,
                              latitudes=[0.0] * len(ids), longitudes=[0.0] * len(ids))
    segs, prev = [], None
    for i in range(0, len(records), packet):
        ing.feed_records(records[i:i + packet])
        for seg in ing.ready_segments():
            segs.append(seg)
            sub = seg if prev is None else type(seg)(
                data=np.concatenate([prev.data, seg.data], axis=1), fs=seg.fs,
                start_epoch=prev.start_epoch, latitudes=seg.latitudes,
                longitudes=seg.longitudes, ids=seg.ids)
            mon.submit(sub)
            prev = seg
    return ing, segs, mon.close()


def arrival_order(records, seed=0):
    """examples/example_streaming_ingest.py's telemetry: each channel lags
    0-2 records (rng seed 0); stable sort by record index plus lag."""
    rng = np.random.default_rng(seed)
    by = {}
    for r in records:
        by.setdefault(r.sid, []).append(r)
    keyed = []
    for sid in sorted(by):
        lag = int(rng.integers(0, 3))
        keyed += [(k + lag, r) for k, r in enumerate(by[sid])]
    keyed.sort(key=lambda kr: kr[0])
    return [r for _, r in keyed]


def test_mseed_ingest_monitor_matches_jax(tmp_path):
    """miniSEED bytes -> port ingest -> port StreamingMonitor on the CPU,
    against the JAX ingest -> JAX monitor on the same bytes, within 1e-4;
    the ingest's segments are the decoded stream's slices, and the port's
    results equal its own ``process()`` of the decoded stream as a whole."""
    st = synthetic_plane_wave(nchans=4, duration_s=240.0, fs=10.0, baz_deg=120.0,
                              trace_vel_kms=0.33, f0=0.7, bandwidth=0.8, snr=10.0,
                              seed=5)
    scale = 2.0 ** 12                 # counts: quantisation far under the noise
    ids = [f"XX.S{c}..BDF" for c in range(st.nchans)]
    buf = b"".join(J.encode_mseed(sid, st.data[c] * scale, st.fs, st.start_epoch)
                   for c, sid in enumerate(ids))
    trecs, jrecs = T.read_mseed_records(buf), J.read_mseed_records(buf)
    assert len(trecs) == len(jrecs) > 4 * 4
    freqlist, nbands, _ = get_freqlist(0.3, 1.5, "log", 2)
    winlens = get_winlenlist("constant", nbands, 15, 0, 0)
    args = (freqlist, "log", winlens, 0.5, 600, st.fs)
    rij = get_rij(st.latitudes, st.longitudes, st.nchans)
    tmon = StreamingMonitor(tplan.make_plan(*args), rij, str(tmp_path / "t"), freqlist,
                            dispatch_segments=2, device="cpu")
    jmon = JMonitor(make_plan(*args), rij, str(tmp_path / "j"), freqlist,
                    dispatch_segments=2)
    ting, tsegs, trun = feed_monitor(T, arrival_order(trecs), tmon)
    jing, jsegs, jrun = feed_monitor(J, arrival_order(jrecs), jmon)
    assert ting.ring.is_native and ting.dropped_records == jing.dropped_records == 0
    _same_segments(tsegs, jsegs)
    whole = T.mseed_to_stream(trecs, {s: (0.0, 0.0) for s in ids})
    assert len(tsegs) == len(trun) == len(jrun) == 4
    for s, seg in enumerate(tsegs):
        np.testing.assert_array_equal(seg.data, whole.data[:, s * 600:(s + 1) * 600])
    got, want = tmon.read_all(), jmon.read_all()
    assert got[4] == want[4]
    np.testing.assert_array_equal(got[3], want[3])
    for k in range(3):
        np.testing.assert_allclose(got[k], want[k], rtol=TOL, atol=TOL)
    ref = StreamingMonitor(tmon.plan, rij, str(tmp_path / "whole"), freqlist,
                           dispatch_segments=2, device="cpu")
    ref.process(whole)
    for a, b in zip(got[:4], ref.read_all()[:4]):
        np.testing.assert_array_equal(a, b)
    good = got[2] > 0.6
    assert good.any() and abs(np.median(got[1][good]) - 120.0) < 10.0
