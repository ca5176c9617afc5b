"""PyTorch port: TSV results persistence and the ArrayStream members the
plotting and acquisition code use, against the JAX package.

The port's ``write_txtfile`` writes the bytes of the JAX package's Python
writer (``use_native=False``), atomically; each package reads the other's
files.  ``len(st)``, ``st[i]`` and ``ArrayStream.from_obspy`` behave as
JAX's (``io/stream.py:94-162``), the latter on a duck-typed stand-in for an
ObsPy Stream, since ObsPy is not installed.
"""

import os

import numpy as np
import pytest

from narrow_band_least_squares_tpu.io import stream as jstream
from narrow_band_least_squares_tpu.io import textio as jtextio
from narrow_band_least_squares_tpu.utils.plan import get_freqlist
from narrow_band_least_squares_tpu_torch.io import stream as tstream
from narrow_band_least_squares_tpu_torch.io import textio as ttextio

from test_torch_pipeline import _tstream


@pytest.fixture(scope="module")
def payload():
    """A seeded 5-band payload with ragged per-band counts, the last band's
    the largest (the reader takes the width from it, as the reference's
    does), and float64 band edges from ``get_freqlist``."""
    rng = np.random.default_rng(20)
    freqlist, nbands, _ = get_freqlist(0.1, 5.0, "log", 5)
    width = 9
    num = [6, 7, 1, 4, 9]
    arrs = [rng.normal(size=(nbands, width)) * s for s in (0.3, 180.0, 1.0)]
    arrs[2] = np.abs(arrs[2]) % 1.0
    t = 19000.0 + np.cumsum(rng.uniform(0, 1e-3, (nbands, width)), axis=1)
    for b, n in enumerate(num):
        for a in (*arrs, t):
            a[b, n:] = 0.0
    return (*arrs, t, np.asarray(freqlist, dtype=np.float64), num)


def _write(mod, d, name, payload, **kw):
    vel, baz, mdccm, t, freqlist, num = payload
    return mod.write_txtfile(str(d), name, vel, baz, mdccm, t, freqlist, num, **kw)


def test_bytes_equal_jax_python_writer(payload, tmp_path):
    got = _write(ttextio, tmp_path / "t", "seg", payload)
    want = _write(jtextio, tmp_path / "j", "seg", payload, use_native=False)
    with open(got, "rb") as f, open(want, "rb") as g:
        assert f.read() == g.read()
    assert os.path.basename(got) == "seg.txt"


@pytest.mark.parametrize("writer,reader", [(ttextio, jtextio), (jtextio, ttextio)],
                         ids=["port-writes-jax-reads", "jax-writes-port-reads"])
def test_round_trip_across_packages(payload, tmp_path, writer, reader):
    vel, baz, mdccm, t, freqlist, num = payload
    kw = {"use_native": False} if writer is jtextio else {}
    _write(writer, tmp_path, "seg", payload, **kw)
    got = reader.read_txtfile(str(tmp_path), "seg")
    want = jtextio.read_txtfile(str(tmp_path), "seg", use_native=False)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    rvel, rbaz, rmd, rt, rfl, rnum = got[:6]
    assert list(rnum) == num and got[6] == len(num)
    np.testing.assert_allclose(rfl, freqlist)
    for b, n in enumerate(num):
        for r, a in ((rvel, vel), (rbaz, baz), (rmd, mdccm), (rt, t)):
            np.testing.assert_array_equal(r[b, :n], a[b, :n])


class _Unprintable:
    def __str__(self):
        raise RuntimeError("cannot format this value")


def test_atomic_write_leaves_no_tmp(payload, tmp_path):
    """A finished write leaves only the .txt; a writer that raises mid-file
    leaves neither a .txt nor a .tmp."""
    _write(ttextio, tmp_path, "good", payload)
    assert sorted(os.listdir(tmp_path)) == ["good.txt"]
    vel, baz, mdccm, t, freqlist, num = payload
    bad = vel.astype(object)
    bad[3, 2] = _Unprintable()
    with pytest.raises(RuntimeError, match="cannot format"):
        ttextio.write_txtfile(str(tmp_path), "bad", bad, baz, mdccm, t, freqlist, num)
    assert sorted(os.listdir(tmp_path)) == ["good.txt"]


def test_array_stream_members_match_jax(small_stream):
    st = small_stream
    tst = _tstream(st)
    assert len(tst) == len(st) == st.nchans
    for i in (0, st.nchans - 1):
        np.testing.assert_array_equal(tst[i].data, st[i].data)
        for kind in ("matplotlib", "epoch", "relative"):
            np.testing.assert_array_equal(tst[i].times(kind), st[i].times(kind))
        np.testing.assert_array_equal(tst[i].times(), st[i].times())
        np.testing.assert_array_equal(np.asarray(tst[i], dtype=np.float32),
                                      np.asarray(st[i], dtype=np.float32))
        assert len(tst[i]) == len(st[i]) == st.npts
    assert type(tst[0]) is tstream._TraceView


class _Stats:
    def __init__(self, npts, lat, lon):
        self.npts, self.latitude, self.longitude = npts, lat, lon
        self.sampling_rate = 20.0
        self.starttime = type("UTC", (), {"timestamp": 1.6e9})()


class _Trace:
    def __init__(self, k, npts):
        self.data = np.arange(npts, dtype=np.int32) * (k + 1)
        self.stats = _Stats(npts, 64.0 + 0.01 * k, -146.0 - 0.01 * k)
        self.id = f"XX.STA{k}..BDF"


def test_from_obspy_matches_jax():
    """The traces are cut to the shortest, cast to float64, and carry their
    coordinates, ids, sampling rate and start time."""
    traces = [_Trace(k, n) for k, n in enumerate((50, 48, 49))]
    got = tstream.ArrayStream.from_obspy(traces)
    want = jstream.ArrayStream.from_obspy(traces)
    assert isinstance(got, tstream.ArrayStream)
    assert got.data.shape == (3, 48) and got.data.dtype == np.float64
    np.testing.assert_array_equal(got.data, want.data)
    assert (got.fs, got.start_epoch, got.ids) == (want.fs, want.start_epoch, want.ids)
    assert (got.latitudes, got.longitudes) == (want.latitudes, want.longitudes)


def test_api_and_root_export_the_codec():
    import narrow_band_least_squares_tpu_torch as p
    from narrow_band_least_squares_tpu_torch import api, io

    for name in ("write_txtfile", "read_txtfile"):
        assert name in api.__all__ and name in p.__all__
        assert getattr(p, name) is getattr(api, name) is getattr(ttextio, name)
        assert getattr(io, name) is getattr(ttextio, name)
