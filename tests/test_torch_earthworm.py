"""PyTorch port: the Earthworm/Winston wave-server client (`io.earthworm`)
against the JAX package, on ``tests/test_earthworm.py``'s loopback
``FakeWaveServer``.

TraceBuf2 parsing (both byte orders, every width) gives the JAX package's
blocks; on every seeded single-byte mutation and truncation it gives the
same blocks or the same ``ValueError``.  MENU, GETSCNLRAW with the fake's
one-sample gap (zero-filled), the ``ew://`` dispatch with its validations
and npz cache, and the three ``remove_response`` cases (a local StationXML,
none given, a channel missing from it) match the JAX package exactly.
Every client here has a 5 s socket timeout, so a stuck server fails the
test instead of hanging the suite.
"""

import numpy as np
import pytest

from narrow_band_least_squares_tpu.io import earthworm as J
from narrow_band_least_squares_tpu.io import stream as jstream
from narrow_band_least_squares_tpu_torch.io import earthworm as T
from narrow_band_least_squares_tpu_torch.io import stream as tstream

from test_earthworm import FS, T0, FakeWaveServer, _forward_counts, _stationxml, make_tracebuf2

TIMEOUT = 5.0
COORDS = {f"ST{i}": (64.0 + i * 1e-3, -148.0) for i in range(4)}


def assert_same_stream(a, b):
    np.testing.assert_array_equal(a.data, b.data)
    assert (a.fs, a.start_epoch, list(a.ids)) == (b.fs, b.start_epoch, list(b.ids))
    assert (list(a.latitudes), list(a.longitudes)) == (list(b.latitudes), list(b.longitudes))


@pytest.fixture(scope="module")
def wave_server():
    """Four elements, one per datatype (i4, s4, i2, t4), 120 s at 20 Hz;
    the second two carry forward-modelled counts of a known response."""
    rng = np.random.default_rng(5)
    n = int(120 * FS)
    t = np.arange(n) / FS
    channels = {}
    for i, dt in enumerate((b"i4", b"s4", b"i2", b"t4")):
        if i < 2:
            x = (rng.standard_normal(n) * 50).astype(np.int32)
        else:
            phys = np.sin(2 * np.pi * (0.5 + 0.4 * i) * t) * np.hanning(n)
            x = _forward_counts(phys, FS)
            x = x.astype(np.int16 if dt == b"i2" else np.float32)
        channels[(f"ST{i}", "BDF", "XX", "--")] = (T0, FS, x, dt)
    srv = FakeWaveServer(channels)
    yield srv, channels
    srv.close()


def outcome(mod, buf):
    try:
        return [{k: (v.tobytes() if isinstance(v, np.ndarray) else v) for k, v in b.items()}
                for b in mod.parse_tracebuf2(buf)]
    except Exception as e:   # noqa: BLE001 - the type is compared below
        return (type(e).__name__, str(e))


@pytest.mark.parametrize("dt", [b"i4", b"s4", b"i2", b"s2", b"f4", b"t4"])
def test_parse_tracebuf2_equals_jax(dt):
    x = np.arange(-5, 40, dtype=np.int32)
    pkt = make_tracebuf2("STA", "NT", "CHZ", "01", T0, FS, x, dt)
    got = outcome(T, pkt + pkt)
    assert got == outcome(J, pkt + pkt)
    assert len(got) == 2
    blocks = T.parse_tracebuf2(pkt)
    assert (blocks[0]["sta"], blocks[0]["net"], blocks[0]["chan"], blocks[0]["loc"]) == \
        ("STA", "NT", "CHZ", "01")
    np.testing.assert_array_equal(blocks[0]["data"], x.astype(np.float64))


def test_parse_tracebuf2_refuses_bad_headers():
    import struct

    pkt = bytearray(make_tracebuf2("STA", "XX", "BDF", "--", T0, FS,
                                   np.arange(50, dtype=np.int32)))
    for nsamp in (10_000, -1):
        struct.pack_into("<i", pkt, 4, nsamp)
        got = outcome(T, bytes(pkt))
        assert got == outcome(J, bytes(pkt)) and got[0] == "ValueError" and "nsamp" in got[1]
    pkt[57:59] = b"zz"
    assert outcome(T, bytes(pkt)) == outcome(J, bytes(pkt))


def test_tracebuf2_mutation_sweep_same_outcome_as_jax():
    base = bytearray(make_tracebuf2("STA", "XX", "BDF", "--", T0, FS,
                                    np.arange(200, dtype=np.int32)))
    rng = np.random.default_rng(1)
    errors = set()
    for _ in range(300):
        buf = bytearray(base + base)
        buf[int(rng.integers(0, len(buf)))] = int(rng.integers(0, 256))
        got = outcome(T, bytes(buf))
        assert got == outcome(J, bytes(buf))
        if isinstance(got, tuple):
            errors.add(got[0])
    for cut in range(1, 120, 7):
        got = outcome(T, bytes(base[:-cut]))
        assert got == outcome(J, bytes(base[:-cut]))
    assert errors <= {"ValueError", "UnicodeDecodeError"}


def test_menu_equals_jax(wave_server):
    srv, _ = wave_server
    got = T.EarthwormClient("127.0.0.1", srv.port, timeout=TIMEOUT).menu()
    assert got == J.EarthwormClient("127.0.0.1", srv.port, timeout=TIMEOUT).menu()
    assert {m["sta"] for m in got} == set(COORDS)
    cl = T.EarthwormClient("127.0.0.1", 1)
    cl._roundtrip = lambda request, binary_len_from_header=None: (
        "0  0 ST0 BDF XX -- extrafield 160.0 170.0 i4", b"")
    with pytest.raises(ValueError, match="malformed MENU"):
        cl.menu()


def test_gap_fill_equals_jax(wave_server):
    srv, channels = wave_server
    t0, t1 = T0 + 10.0, T0 + 50.0
    blocks = T.EarthwormClient("127.0.0.1", srv.port, timeout=TIMEOUT).get_scnl_raw(
        "ST0", "BDF", "XX", "--", t0, t1)
    assert len(blocks) == 2
    args = ("127.0.0.1", srv.port, "XX", ["ST0", "ST1", "ST2"], "--", "BDF", t0, t1)
    got = T.gather_waveforms_earthworm(*args, coordinates=COORDS, timeout=TIMEOUT)
    assert_same_stream(got, J.gather_waveforms_earthworm(*args, coordinates=COORDS,
                                                         timeout=TIMEOUT))
    truth = channels[("ST0", "BDF", "XX", "--")][2]
    i0 = int((t0 - T0) * FS)
    off = np.flatnonzero(got.data[0] != truth[i0:i0 + got.npts])
    assert len(off) == 1 and got.data[0][off[0]] == 0.0
    with pytest.raises(RuntimeError, match="no data"):
        T.gather_waveforms_earthworm("127.0.0.1", srv.port, "XX", ["NOPE"], "--", "BDF",
                                     t0, t1, coordinates={"NOPE": (0.0, 0.0)},
                                     timeout=TIMEOUT)
    with pytest.raises(ValueError, match="no coordinates"):
        T.gather_waveforms_earthworm(*args, coordinates={"ST0": (0.0, 0.0)},
                                     timeout=TIMEOUT)


def test_dispatch_validation_and_cache_equal_jax(wave_server, tmp_path):
    srv, _ = wave_server
    src = f"ew://127.0.0.1:{srv.port}"
    args = ("XX", "ST0,ST1,ST3", "--", "BDF", T0 + 10.0, T0 + 50.0)
    kw = dict(remove_response=False, coordinates=COORDS, timeout=TIMEOUT)
    got = tstream.gather_waveforms(src, *args, cache=str(tmp_path / "ew.npz"), **kw)
    assert_same_stream(got, jstream.gather_waveforms(src, *args, **kw))
    again = tstream.gather_waveforms("ew://127.0.0.1:1", *args,
                                     cache=str(tmp_path / "ew.npz"))
    assert_same_stream(again, got)
    for source, station, match in (("ew://hostonly", "ST0", "host:port"),
                                   ("winston://h:123", "ST*", "wildcard"),
                                   ("waveserver://h:123", ",", "empty station list")):
        for mod in (tstream, jstream):
            with pytest.raises(ValueError, match=match):
                mod.gather_waveforms(source, "XX", station, "--", "BDF", T0, T0 + 10,
                                     remove_response=False)


def test_remove_response_equals_jax(wave_server):
    """A local StationXML given as text: the deconvolved traces
    equal the JAX package's, and equal `io.response.remove_response` of
    the counts."""
    from narrow_band_least_squares_tpu_torch.io.response import parse_stationxml, remove_response

    srv, _ = wave_server
    stations = ["ST2", "ST3"]
    xml = _stationxml(stations)
    args = ("127.0.0.1", srv.port, "XX", stations, "--", "BDF", T0 + 5.0, T0 + 60.0)
    kw = dict(coordinates=COORDS, timeout=TIMEOUT, remove_response=True)
    got = T.gather_waveforms_earthworm(*args, response_xml=xml, **kw)
    assert_same_stream(got, J.gather_waveforms_earthworm(*args, response_xml=xml, **kw))
    counts = T.gather_waveforms_earthworm(*args[:-2], T0 + 5.0, T0 + 60.0,
                                          coordinates=COORDS, timeout=TIMEOUT)
    responses = parse_stationxml(xml)
    for i, sta in enumerate(stations):
        np.testing.assert_array_equal(
            got.data[i], remove_response(counts.data[i], counts.fs,
                                         responses[f"XX.{sta}..BDF"]))


def test_remove_response_from_a_file_and_refusals(wave_server, tmp_path):
    srv, _ = wave_server
    path = tmp_path / "resp.xml"
    path.write_text(_stationxml(["ST2"]))
    args = ("127.0.0.1", srv.port, "XX", ["ST2"], "--", "BDF", T0, T0 + 30.0)
    kw = dict(coordinates=COORDS, timeout=TIMEOUT, remove_response=True)
    assert_same_stream(T.gather_waveforms_earthworm(*args, response_xml=path, **kw),
                       J.gather_waveforms_earthworm(*args, response_xml=str(path), **kw))
    for mod in (T, J):
        with pytest.raises(ValueError, match="remove_response"):
            mod.gather_waveforms_earthworm(*args, **kw)
        with pytest.raises(ValueError, match="no instrument response"):
            mod.gather_waveforms_earthworm("127.0.0.1", srv.port, "XX", ["ST2", "ST3"], "--",
                                           "BDF", T0, T0 + 30.0, response_xml=str(path), **kw)


def test_metadata_source_serves_coordinates_and_responses(wave_server, monkeypatch):
    """``metadata_source=``: coordinates from the FDSN station text and the
    responses from its ``level=response`` document, both served by a
    stand-in for each package's ``io.fdsn._http_get``."""
    from narrow_band_least_squares_tpu.io import fdsn as jfdsn
    from narrow_band_least_squares_tpu_torch.io import fdsn as tfdsn

    srv, _ = wave_server
    stations = ["ST2", "ST3"]
    text = "#header\n" + "".join(
        f"XX|{sta}||BDF|{64.0 + i}|{-148.0 - i}|0|0|0|0|s|1000.0|1.0|Pa|20.0|x|\n"
        for i, sta in enumerate(stations))
    urls = []

    def fake_get(url, timeout=60.0):
        urls.append(url)
        return (_stationxml(stations) if "level=response" in url else text).encode()

    monkeypatch.setattr(tfdsn, "_http_get", fake_get)
    monkeypatch.setattr(jfdsn, "_http_get", fake_get)
    args = ("127.0.0.1", srv.port, "XX", stations, "--", "BDF", T0, T0 + 30.0)
    kw = dict(metadata_source="IRIS", remove_response=True, timeout=TIMEOUT)
    got = T.gather_waveforms_earthworm(*args, **kw)
    assert len(urls) == 2 and all(u.startswith("https://service.iris.edu/") for u in urls)
    assert_same_stream(got, J.gather_waveforms_earthworm(*args, **kw))
    assert got.latitudes == [64.0, 65.0] and got.longitudes == [-148.0, -149.0]
