"""PyTorch port: ``tests/test_api_coverage.py``'s reference behaviours
through the port's API, against the JAX package's on the CPU.

Every band family a config file may name (``FREQ_BAND_TYPE``) runs end to
end and matches JAX within 1e-4 (rtol and atol) on every valid window, but
'octave_linear', whose band list repeats the 2 Hz switch edge in the
reference's construction (a zero-width band), fails in both packages with
the same band-edge ``ValueError``;
the zero-phase butter pipeline matches JAX and the NumPy oracle; the same
input gives the same output twice.
"""

import numpy as np
import pytest

from narrow_band_least_squares_tpu import api as japi
from narrow_band_least_squares_tpu.oracle.pipeline import narrow_band_least_squares_oracle
from narrow_band_least_squares_tpu_torch import api as tapi
from narrow_band_least_squares_tpu_torch.config import FREQ_BAND_TYPES
from narrow_band_least_squares_tpu_torch.io.stream import ArrayStream
from narrow_band_least_squares_tpu_torch.utils.plan import get_freqlist, get_winlenlist

TOL = 1e-4
# (FMIN, FMAX, NBANDS) per family on the 10 Hz fixture (test_api_coverage.py's)
BANDS = {
    "linear": (0.3, 1.5, 3),
    "log": (0.3, 1.5, 3),
    "octave": (0.2, 1.6, 99),
    "2_octave_over": (0.2, 1.6, 99),
    "onethird_octave": (0.4, 1.2, 99),
    "octave_linear": (0.3, 2.0, 5),
}


def _tstream(st):
    return ArrayStream(data=st.data, fs=st.fs, start_epoch=st.start_epoch,
                       latitudes=list(st.latitudes), longitudes=list(st.longitudes))


def _run(api, st, freqlist, nbands, winlens, band_type, filter_type="cheby1", **kw):
    fr = np.logspace(-2, np.log10(st.fs / 2), 40)
    return api.narrow_band_least_squares(
        winlens, 0.5, 1.0, st, st.latitudes, st.longitudes,
        nbands, None, None, freqlist, band_type, fr, filter_type, 2, 0.01, **kw,
    )


def _assert_close(got, want):
    assert list(got[6]) == list(want[6])
    for b, n in enumerate(got[6]):
        np.testing.assert_array_equal(got[3][b, :n], want[3][b, :n])
        for i in (0, 2, 5):
            np.testing.assert_allclose(got[i][b, :n], want[i][b, :n], rtol=TOL, atol=TOL)
        d = np.abs((got[1][b, :n] - want[1][b, :n] + 180.0) % 360.0 - 180.0)
        assert (d <= TOL + TOL * np.abs(want[1][b, :n])).all()


def test_every_band_family_is_covered():
    assert set(BANDS) == set(FREQ_BAND_TYPES)


@pytest.mark.parametrize("band_type", list(BANDS))
def test_band_family_end_to_end_matches_jax(band_type, small_stream):
    st = small_stream
    fmin, fmax, nb = BANDS[band_type]
    freqlist, nbands, _ = get_freqlist(fmin, fmax, band_type, nb)
    winlens = get_winlenlist("constant", nbands, 30, 0, 0)
    if band_type == "octave_linear":
        assert freqlist[2] == freqlist[3] == 1.2
        with pytest.raises(ValueError, match="band edges") as jerr:
            _run(japi, st, freqlist, nbands, winlens, band_type)
        with pytest.raises(ValueError, match="band edges") as terr:
            _run(tapi, _tstream(st), freqlist, nbands, winlens, band_type, device="cpu")
        assert str(terr.value) == str(jerr.value)
        return
    got = _run(tapi, _tstream(st), freqlist, nbands, winlens, band_type, device="cpu")
    want = _run(japi, st, freqlist, nbands, winlens, band_type)
    assert got[0].shape[0] == nbands
    _assert_close(got, want)
    if band_type == "2_octave_over":
        # overlapping two-octave bands still recover the wave
        for b in range(nbands):
            good = got[2][b, :got[6][b]] > 0.6
            if good.sum() > 5:
                d = np.abs((got[1][b, :got[6][b]][good] - 230.0 + 180.0) % 360.0 - 180.0)
                assert np.median(d) < 10.0


def test_butter_zerophase_matches_jax_and_the_oracle(small_stream):
    st = small_stream
    freqlist, nbands, _ = get_freqlist(0.3, 1.2, "log", 2)
    winlens = get_winlenlist("constant", nbands, 30, 0, 0)
    fr = np.logspace(-2, np.log10(st.fs / 2), 40)
    got = _run(tapi, _tstream(st), freqlist, nbands, winlens, "log", "butter", device="cpu")
    _assert_close(got, _run(japi, st, freqlist, nbands, winlens, "log", "butter"))
    o = narrow_band_least_squares_oracle(
        winlens, 0.5, 1.0, st, st.latitudes, st.longitudes,
        nbands, freqlist, "log", fr, "butter", 2, 0.01,
    )
    for b, n in enumerate(got[6]):
        good = o[2][b, :n] > 0.6
        d = np.abs((got[1][b, :n] - o[1][b, :n] + 180.0) % 360.0 - 180.0)
        assert np.median(d[good]) < 2.0


def test_same_input_same_output(small_stream):
    st = _tstream(small_stream)
    freqlist, nbands, _ = get_freqlist(0.3, 1.2, "log", 2)
    winlens = get_winlenlist("constant", nbands, 30, 0, 0)
    a = _run(tapi, st, freqlist, nbands, winlens, "log", device="cpu")
    tapi.set_performance_defaults()          # clears the pipeline cache
    b = _run(tapi, st, freqlist, nbands, winlens, "log", device="cpu")
    for i in (0, 1, 2, 5):
        np.testing.assert_array_equal(a[i], b[i])
