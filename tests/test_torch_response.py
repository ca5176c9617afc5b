"""PyTorch port: instrument-response removal (`io.response`) against the
JAX package.

The port's module is the JAX package's host NumPy, line for line, so every
output must be equal exactly: the parsed stages of
``tests/data/i53_synth_event.xml`` (the golden fixture, 8 channels of
poles/zeros, gain and FIR stages) and of ``tests/test_response.py``'s
document, the complex transfer function on a frequency grid, and the
deconvolved traces (water level, pre-filter, without demeaning).  The
physical checks of ``tests/test_response.py`` (scipy's ``freqs_zpk`` /
``freqz``, the forward-modelled round trip) run on the port too.
"""

import os

import numpy as np
import pytest
from scipy import signal

from narrow_band_least_squares_tpu.io import response as J
from narrow_band_least_squares_tpu_torch.io import response as T

import test_response
from test_response import A0, FIR, POLES, SENSITIVITY, SENSOR_GAIN, ZEROS, _xml

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")


def _fixture_xml():
    with open(os.path.join(DATA, "i53_synth_event.xml")) as f:
        return f.read()


DOCS = {"fixture": _fixture_xml, "test-response": _xml,
        "no-fir": lambda: _xml(include_fir=False)}


def _same_stage(a, b):
    assert type(a).__name__ == type(b).__name__
    for k, v in vars(b).items():
        w = getattr(a, k)
        if isinstance(v, np.ndarray):
            assert w.dtype == v.dtype
            np.testing.assert_array_equal(w, v)
        else:
            assert w == v, k


def _parsed(doc):
    got, want = T.parse_stationxml(doc), J.parse_stationxml(doc)
    assert list(got) == list(want)
    for sid in want:
        g, w = got[sid], want[sid]
        assert (g.sensitivity, g.sensitivity_freq, g.input_units) == \
            (w.sensitivity, w.sensitivity_freq, w.input_units)
        assert len(g.stages) == len(w.stages)
        for a, b in zip(g.stages, w.stages):
            _same_stage(a, b)
        assert g.stage_gain_product() == w.stage_gain_product()
    return got, want


@pytest.mark.parametrize("doc", list(DOCS))
def test_parse_equals_jax(doc):
    got, _ = _parsed(DOCS[doc]())
    if doc == "fixture":
        assert len(got) == 8 and all(sid.startswith("IM.I53H") for sid in got)


def test_parse_known_answers():
    """``test_response.py::TestParsing`` on the port."""
    resp = T.parse_stationxml(_xml())["IM.I53H1..BDF"]
    assert resp.sensitivity == pytest.approx(SENSITIVITY)
    assert resp.input_units == "Pa" and len(resp.stages) == 3
    pz, fir = resp.stages[0], resp.stages[2]
    assert isinstance(pz, T.PolesZerosStage) and isinstance(fir, T.CoefficientsStage)
    np.testing.assert_allclose(sorted(pz.poles.imag), sorted(p.imag for p in POLES))
    assert pz.normalization == pytest.approx(A0) and pz.gain == pytest.approx(SENSOR_GAIN)
    np.testing.assert_allclose(fir.numerator, FIR)
    assert fir.input_sample_rate == 20.0 and fir.delay_correction == pytest.approx(0.05)


@pytest.mark.parametrize("doc", list(DOCS))
@pytest.mark.parametrize("overall", [True, False], ids=["overall", "stage-gains"])
def test_evaluate_equals_jax(doc, overall):
    got, want = _parsed(DOCS[doc]())
    freqs = np.concatenate([[0.0], np.logspace(-3, 1, 300)])
    for sid in want:
        np.testing.assert_array_equal(
            T.evaluate_response(got[sid], freqs, use_overall_sensitivity=overall),
            J.evaluate_response(want[sid], freqs, use_overall_sensitivity=overall))


def test_evaluate_digital_pz_stage():
    """A z-transform poles/zeros stage (no document above has one)."""
    kw = dict(poles=np.array([0.5 + 0.1j, 0.5 - 0.1j]), zeros=np.array([-1.0 + 0j]),
              normalization=0.7, normalization_freq=1.0, gain=3.0,
              transfer_type="DIGITAL (Z-TRANSFORM)", input_sample_rate=20.0)
    freqs = np.linspace(0.0, 10.0, 101)
    got = T.evaluate_response(T.InstrumentResponse(0.0, 1.0, [T.PolesZerosStage(**kw)]), freqs)
    want = J.evaluate_response(J.InstrumentResponse(0.0, 1.0, [J.PolesZerosStage(**kw)]), freqs)
    np.testing.assert_array_equal(got, want)


def test_evaluate_matches_scipy():
    """``test_response.py::TestEvaluation``: the analog stage against
    ``freqs_zpk`` and the FIR stage against ``freqz``."""
    resp = T.parse_stationxml(_xml())["IM.I53H1..BDF"]
    freqs = np.linspace(0.05, 9.0, 200)
    _, h = signal.freqs_zpk(ZEROS, POLES, A0 * SENSOR_GAIN, worN=2 * np.pi * freqs)
    only = T.InstrumentResponse(sensitivity=0.0, sensitivity_freq=1.0,
                                stages=[resp.stages[0]])
    np.testing.assert_allclose(T.evaluate_response(only, freqs, False), h, rtol=1e-10)
    _, h = signal.freqz(FIR, worN=freqs, fs=20.0)
    only.stages = [resp.stages[2]]
    np.testing.assert_allclose(T.evaluate_response(only, freqs, False),
                               h * np.exp(2j * np.pi * freqs * 0.05), rtol=1e-10,
                               atol=1e-12)


CASES = {
    "default": {},
    "water-level-20": {"water_level_db": 20.0},
    "pre-filter": {"pre_filt": (0.005, 0.01, 8.0, 9.9)},
    "no-demean": {"demean": False},
}


@pytest.mark.parametrize("case", list(CASES))
def test_remove_response_equals_jax(case):
    """Every fixture channel, on seeded counts with an offset."""
    got, want = _parsed(_fixture_xml())
    rng = np.random.default_rng(7)
    for sid in want:
        x = rng.normal(scale=4e5, size=3001) + 1e4
        np.testing.assert_array_equal(
            T.remove_response(x, 20.0, got[sid], **CASES[case]),
            J.remove_response(x, 20.0, want[sid], **CASES[case]))


def test_round_trip_recovers_physical_signal():
    """``test_response.py``'s forward-modelled round trip on the port."""
    resp = T.parse_stationxml(_xml())["IM.I53H1..BDF"]
    fs = 20.0
    t = np.arange(int(120 * fs)) / fs
    rng = np.random.default_rng(7)
    x = sum(a * np.sin(2 * np.pi * f0 * t + rng.uniform(0, 2 * np.pi))
            for f0, a in [(0.5, 1.0), (1.3, 0.6), (3.0, 0.3)])
    x = x * signal.windows.tukey(t.size, 0.1)
    counts = test_response.TestDeconvolution()._forward_apply(x, fs)
    out = T.remove_response(counts, fs, resp, water_level_db=60.0)
    sl = slice(int(10 * fs), int(110 * fs))
    assert np.abs(out[sl] - x[sl]).max() < 5e-3 * np.abs(x[sl]).max()
    noise = T.remove_response(rng.normal(size=1200), fs, resp)
    assert np.isfinite(noise).all() and np.abs(noise).max() < 1e9
