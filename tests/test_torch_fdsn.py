"""PyTorch port: the stdlib FDSN client (`io.fdsn`) and ``gather_waveforms``
against the JAX package.

Mirrors ``tests/test_fdsn.py``.  Every input is served offline: the golden
fixture's miniSEED, station text and StationXML through
``tests/test_golden_event.py``'s fetcher, and ``tests/test_fdsn.py``'s
station text with records built by ``tests/test_ingest.py``.  URLs, parsed
channels and the gathered ``ArrayStream`` (data, ids, coordinates, rate,
start) must equal the JAX package's exactly, with full deconvolution, with
the sensitivity fallback when the response document fails, and without
response removal.  ``gather_waveforms`` falls back to the stdlib client
where ObsPy is missing (here it is missing) and reads and writes its npz
cache.
"""

import builtins
import urllib.parse
import urllib.request

import numpy as np
import pytest

from narrow_band_least_squares_tpu.io import fdsn as J
from narrow_band_least_squares_tpu.io import stream as jstream
from narrow_band_least_squares_tpu_torch.io import fdsn as T
from narrow_band_least_squares_tpu_torch.io import stream as tstream

from test_fdsn import STATION_TEXT, T0, T1
from test_golden_event import _fixture_fetch
from test_ingest import make_int32_record


def assert_same_stream(a, b):
    np.testing.assert_array_equal(a.data, b.data)
    assert a.data.dtype == b.data.dtype == np.float64
    assert (a.fs, a.start_epoch, list(a.ids)) == (b.fs, b.start_epoch, list(b.ids))
    assert list(a.latitudes) == list(b.latitudes)
    assert list(a.longitudes) == list(b.longitudes)


@pytest.mark.parametrize("source", ["IRIS", "geofon", "https://my.dc.example/"])
@pytest.mark.parametrize("url_fn", ["dataselect_url", "station_url", "station_response_url"])
def test_urls_equal_jax(source, url_fn):
    for args in (("IM", "I53H?", "*", "BDF", T0, T1), ("XX", "S", "", "BDF", 1545183900.5, T1)):
        got = getattr(T, url_fn)(source, *args)
        assert got == getattr(J, url_fn)(source, *args)
    q = dict(urllib.parse.parse_qsl(urllib.parse.urlparse(got).query))
    assert q["loc"] == "--" and q["start"] == "2018-12-19T01:45:00.500000"


def test_url_known_answers_and_unknown_source():
    u = T.dataselect_url("IRIS", "IM", "I53H?", "*", "BDF", T0, T1)
    assert u.startswith("https://service.iris.edu/fdsnws/dataselect/1/query?")
    q = dict(urllib.parse.parse_qsl(urllib.parse.urlparse(u).query))
    assert (q["net"], q["sta"], q["cha"], q["format"]) == ("IM", "I53H?", "BDF", "miniseed")
    assert q["start"] == "2018-12-19T01:45:00.000000"
    assert T.DATA_CENTERS == J.DATA_CENTERS
    for mod in (T, J):
        with pytest.raises(ValueError, match="unknown FDSN source"):
            mod.dataselect_url("NOPE", "XX", "S", "", "BDF", T0, T1)


@pytest.mark.parametrize("text", [STATION_TEXT, "\n# comment\nshort|row\n",
                                  STATION_TEXT.replace("40000.0", "n/a")],
                         ids=["two-channels", "blank-and-short", "unparsable-scale"])
def test_parse_station_text_equals_jax(text):
    got, want = T.parse_station_text(text), J.parse_station_text(text)
    assert [vars(c) for c in got] == [vars(c) for c in want]


def _fixture_args(meta):
    t0 = meta["start_epoch"]
    return ("IRIS", "IM", "I53H*", "", "BDF", t0, t0 + meta["duration_s"])


@pytest.fixture(scope="module")
def meta():
    import json
    import os

    from test_golden_event import DATA

    with open(os.path.join(DATA, "i53_synth_event_meta.json")) as f:
        return json.load(f)


def _failing_response(url, timeout=60.0):
    if "level=response" in url:
        raise OSError("stand-in: the response service is down")
    return _fixture_fetch(url, timeout)


@pytest.mark.parametrize("fetch,remove", [(_fixture_fetch, True), (_failing_response, True),
                                          (_fixture_fetch, False)],
                         ids=["deconvolved", "sensitivity-fallback", "counts"])
def test_gather_fixture_equals_jax(meta, fetch, remove):
    got = T.gather_waveforms_fdsn(*_fixture_args(meta), remove_response=remove, _fetch=fetch)
    want = J.gather_waveforms_fdsn(*_fixture_args(meta), remove_response=remove, _fetch=fetch)
    assert_same_stream(got, want)
    assert got.nchans == meta["nchans"] and got.npts == int(meta["duration_s"] * meta["fs"])


def test_sensitivity_fallback_divides_by_scale(meta):
    """Without the response document, counts divided by the Scale column."""
    counts = T.gather_waveforms_fdsn(*_fixture_args(meta), remove_response=False,
                                     _fetch=_fixture_fetch)
    sens = T.gather_waveforms_fdsn(*_fixture_args(meta), remove_response=True,
                                   _fetch=_failing_response)
    np.testing.assert_array_equal(sens.data, counts.data / meta["sensitivity"])


def test_end_to_end_offline_trims_and_scales():
    """``test_fdsn.py::TestGather::test_end_to_end_offline`` on the port,
    against the JAX package's result."""
    rng = np.random.default_rng(2)
    counts, buf = {}, b""
    for sta in ["I53H1", "I53H2"]:
        x = rng.integers(-(2 ** 20), 2 ** 20, 4000)
        counts[sta] = x
        for k in range(0, 4000, 500):
            secs = k / 20.0
            buf += make_int32_record(list(x[k:k + 500]), sta=sta, fs=20, reclen=4096,
                                     mm=45 + int(secs // 60), ss=int(secs % 60))

    def fetch(url, timeout=0):
        return buf if "/dataselect/" in url else STATION_TEXT.encode()

    args = ("IRIS", "IM", "I53H?", "", "BDF", "2018-12-19T01:45:00", "2018-12-19T01:47:00")
    st = T.gather_waveforms_fdsn(*args, remove_response=True, _fetch=fetch)
    assert_same_stream(st, J.gather_waveforms_fdsn(*args, remove_response=True, _fetch=fetch))
    assert (st.nchans, st.fs, st.npts) == (2, 20.0, 2400)
    assert st.latitudes[0] == pytest.approx(64.8745)
    np.testing.assert_allclose(st.data[0], counts["I53H1"][:2400] / 40000.0)
    with pytest.raises(ValueError, match="no records"):
        T.gather_waveforms_fdsn(*args, _fetch=lambda url, timeout=0: b"")


@pytest.fixture
def no_obspy_offline(monkeypatch):
    """ObsPy unimportable, and ``urllib.request.urlopen`` serving
    ``test_fdsn.py``'s station text and two records, as that file's
    fallback test does.  Yields the URLs asked for."""
    real_import = builtins.__import__

    def no_obspy(name, *a, **k):
        if name.startswith("obspy"):
            raise ImportError("obspy not installed")
        return real_import(name, *a, **k)

    buf = b"".join(make_int32_record(list(range(2400)), sta=sta, fs=20, reclen=16384)
                   for sta in ["I53H1", "I53H2"])
    urls = []

    class FakeResp:
        def __init__(self, data):
            self._d = data

        def read(self):
            return self._d

        def __enter__(self):
            return self

        def __exit__(self, *a):
            return False

    def fake_open(req, timeout=0):
        url = req.full_url if hasattr(req, "full_url") else req
        urls.append(url)
        if "level=response" in url:
            raise OSError("no response document")
        return FakeResp(buf if "/dataselect/" in url else STATION_TEXT.encode())

    monkeypatch.setattr(builtins, "__import__", no_obspy)
    monkeypatch.setattr(urllib.request, "urlopen", fake_open)
    yield urls


def test_gather_waveforms_falls_back_without_obspy(no_obspy_offline, tmp_path):
    args = ("IRIS", "IM", "I53H?", "", "BDF", "2018-12-19T01:45:00", "2018-12-19T01:47:00")
    cache = str(tmp_path / "c.npz")
    st = tstream.gather_waveforms(*args, cache=cache)
    assert (st.nchans, st.npts) == (2, 2400)
    assert any("/dataselect/" in u for u in no_obspy_offline)
    assert_same_stream(st, jstream.gather_waveforms(*args))
    n = len(no_obspy_offline)
    again = tstream.gather_waveforms(*args, cache=cache)     # from the cache
    assert len(no_obspy_offline) == n
    assert_same_stream(again, st)
