"""PyTorch port: the recorded-event golden regression
(``tests/test_golden_event.py``) run through the port's acquisition and API
on the CPU.

The fixture's miniSEED and StationXML bytes are decoded and deconvolved by
the port's own recorded-data path (`io.fdsn.gather_waveforms_fdsn`: the
C++ miniSEED decoder, StationXML parsing, water-level deconvolution),
served by the JAX test's offline fetcher; the resulting ``ArrayStream``
equals the JAX package's exactly (data, ids, coordinates, rate, start).
The port's
``narrow_band_least_squares`` runs at ALPHA 1.0 (OLS) and 0.75 (LTS) and is
held to ``tests/data/golden.json``: window counts, confident-window counts
and the LTS stdict's window count exactly (a window whose MdCCM lies within
1e-5 of the 0.5 threshold would be excused, and named; none does), and the
per-band medians within 1e-4 relative.
"""

import json
import os

import numpy as np
import pytest

from narrow_band_least_squares_tpu.io.fdsn import gather_waveforms_fdsn as jgather
from narrow_band_least_squares_tpu_torch import api as tapi
from narrow_band_least_squares_tpu_torch.io.fdsn import gather_waveforms_fdsn
from narrow_band_least_squares_tpu_torch.io.stream import ArrayStream

from test_golden_event import (
    DATA, FMAX, FMIN, GOLDEN, NBANDS, WINLEN_1, WINLEN_X, _fixture_fetch,
)

THRESH = 0.5          # the golden's confident-window MdCCM threshold
EDGE = 1e-5           # windows this close to it may fall either side
RTOL = 1e-4           # per-band medians


@pytest.fixture(scope="module")
def meta():
    with open(os.path.join(DATA, "i53_synth_event_meta.json")) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def golden():
    with open(GOLDEN) as f:
        return json.load(f)


def _gather(fn, meta):
    t0 = meta["start_epoch"]
    return fn("IRIS", "IM", "I53H*", "", "BDF", t0, t0 + meta["duration_s"],
              remove_response=True, _fetch=_fixture_fetch)


@pytest.fixture(scope="module")
def stream(meta):
    return _gather(gather_waveforms_fdsn, meta)


def test_stream_equals_jax_acquisition(stream, meta):
    want = _gather(jgather, meta)
    assert isinstance(stream, ArrayStream)
    np.testing.assert_array_equal(stream.data, want.data)
    assert (stream.fs, stream.start_epoch) == (want.fs, want.start_epoch)
    assert list(stream.ids) == list(want.ids)
    assert list(stream.latitudes) == list(want.latitudes)
    assert list(stream.longitudes) == list(want.longitudes)
    assert stream.nchans == meta["nchans"]


@pytest.fixture(scope="module")
def results(stream):
    tst = stream
    freqlist, nbands, _ = tapi.get_freqlist(FMIN, FMAX, "log", NBANDS)
    winlens = tapi.get_winlenlist("adaptive", nbands, 20, WINLEN_1, WINLEN_X)
    fr = np.logspace(-2, np.log10(tst.fs / 2), 50)
    return {alpha: tapi.narrow_band_least_squares(
        winlens, 0.5, alpha, tst, tst.latitudes, tst.longitudes, nbands, None,
        None, freqlist, "log", fr, "cheby1", 2, 0.01, device="cpu")
        for alpha in (1.0, 0.75)}


def _edge_windows(mdccm, ncl):
    """(band, window) of the windows whose MdCCM lies within EDGE of THRESH."""
    return [(b, int(w)) for b, n in enumerate(ncl)
            for w in np.where(np.abs(mdccm[b, :n] - THRESH) <= EDGE)[0]]


def test_window_counts_match_golden(results, golden):
    vel, baz, mdccm, _, stdict0, _, ncl, _, _ = results[1.0]
    edge = _edge_windows(mdccm, ncl)
    assert edge == [], f"windows at the MdCCM threshold: {edge}"
    assert stdict0 is None
    for b, want in enumerate(golden["bands"]):
        n = ncl[b]
        assert n == want["n_windows"], f"band {b}"
        assert int((mdccm[b, :n] > THRESH).sum()) == want["n_good"], f"band {b}"
    stdict = results[0.75][4]
    assert sum(1 for k in stdict if k != "size") == golden["lts_flagged_windows"]


@pytest.mark.parametrize("key,col", [("median_baz", 1), ("median_vel", 0),
                                     ("median_mdccm", 2)])
def test_band_medians_match_golden(results, golden, key, col):
    out = results[1.0]
    mdccm, ncl = out[2], out[6]
    for b, want in enumerate(golden["bands"]):
        n = ncl[b]
        good = mdccm[b, :n] > THRESH
        assert want[key] is not None and good.any()
        got = float(np.median(out[col][b, :n][good]))
        assert got == pytest.approx(want[key], rel=RTOL), f"band {b} {key}"


def test_lts_flags_outlier_and_recovers_event(results, meta):
    """Mirror of ``test_golden_event.py:97,119``: the incoherent element is
    the most flagged, and LTS recovers the event where OLS is biased."""
    stdict = results[0.75][4]
    assert stdict["size"] == meta["nchans"]
    counts = np.zeros(meta["nchans"] + 1)
    for k, v in stdict.items():
        if k != "size":
            np.add.at(counts, np.asarray(v, dtype=np.int64), 1)
    assert counts.argmax() == meta["outlier_channel"] + 1
    vel, baz, mdccm = results[0.75][:3]
    good = mdccm > THRESH
    d = np.abs((baz[good] - meta["baz_deg"] + 180.0) % 360.0 - 180.0)
    assert np.median(d) < 3.0
    assert abs(np.median(vel[good]) - meta["trace_vel_kms"]) < 0.03
