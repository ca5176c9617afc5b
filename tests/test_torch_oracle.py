"""PyTorch port: the port's copy of the NumPy/SciPy oracle
(`narrow_band_least_squares_tpu_torch.oracle`) against the JAX package's
``narrow_band_least_squares_tpu.oracle``, bit for bit on the same inputs,
and the port's CPU pipeline against it at ``tests/test_jax_pipeline.py``'s
tolerances.

The two oracles are the same code on the same NumPy/SciPy, over each
package's own geometry, plan and time helpers (equal line for line), so
every output, stdicts included, must be equal exactly.
"""

import dataclasses

import numpy as np
import pytest

from narrow_band_least_squares_tpu import oracle as JO
from narrow_band_least_squares_tpu.utils.plan import get_freqlist, get_winlenlist
from narrow_band_least_squares_tpu_torch import api as tapi
from narrow_band_least_squares_tpu_torch import oracle as TO

from test_torch_pipeline import _tstream


def _equal(a, b, what):
    if dataclasses.is_dataclass(a):     # each package's own WindowPlan
        assert type(a).__name__ == type(b).__name__, what
        _equal(dataclasses.asdict(a), dataclasses.asdict(b), what)
    elif isinstance(a, dict) or isinstance(b, dict):
        assert a.keys() == b.keys(), what
        for k in a:
            _equal(a[k], b[k], f"{what}[{k!r}]")
    elif a is None or b is None:
        assert a is None and b is None, what
    elif isinstance(a, (tuple, list)) and not isinstance(a, np.ndarray):
        assert len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            _equal(x, y, f"{what}[{i}]")
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=what)


def test_public_names_equal_jax():
    assert sorted(TO.__all__) == sorted(JO.__all__)


@pytest.mark.parametrize("kind", ["cheby1", "butter"])
def test_design_and_filter_equal_jax(small_stream, kind):
    st = small_stream
    _equal(TO.design_sos(kind, 0.3, 1.2, 2, 0.01, st.fs),
           JO.design_sos(kind, 0.3, 1.2, 2, 0.01, st.fs), "sos")
    _equal(TO.filter_and_taper(st.data, st.fs, kind, 0.2, 1.2, 2, 0.01),
           JO.filter_and_taper(st.data, st.fs, kind, 0.2, 1.2, 2, 0.01), "filtered")


@pytest.mark.parametrize("alpha,xcorr", [(1.0, "time"), (0.75, "time"), (0.75, "fft")])
def test_sliding_window_solve_equals_jax(outlier_stream, alpha, xcorr):
    st = outlier_stream
    filt, _ = JO.filter_and_taper(st.data, st.fs, "cheby1", 0.2, 1.2, 2, 0.01)
    from narrow_band_least_squares_tpu.utils.geometry import get_rij
    rij = get_rij(st.latitudes, st.longitudes, st.nchans)
    args = (filt, rij, st.fs, st.start_epoch, 30.0, 0.5, alpha)
    _equal(TO.sliding_window_solve(*args, xcorr_method=xcorr),
           JO.sliding_window_solve(*args, xcorr_method=xcorr), "solve")


@pytest.mark.parametrize("alpha", [1.0, 0.75])
def test_ltsva_oracle_equals_jax(outlier_stream, alpha):
    st = outlier_stream
    stf = st.copy()
    stf.data, _ = JO.filter_and_taper(st.data, st.fs, "cheby1", 0.2, 1.2, 2, 0.01)
    tst = _tstream(stf)
    _equal(TO.ltsva_oracle(tst, st.latitudes, st.longitudes, 30.0, 0.5, alpha),
           JO.ltsva_oracle(stf, st.latitudes, st.longitudes, 30.0, 0.5, alpha), "ltsva")


@pytest.mark.parametrize("alpha", [1.0, 0.75])
def test_narrow_band_oracle_equals_jax(outlier_stream, alpha):
    st = outlier_stream
    fl, nb, _ = get_freqlist(0.2, 1.6, "log", 3)
    wl = get_winlenlist("adaptive", nb, 30, 40, 20)
    fr = np.logspace(-2, np.log10(st.fs / 2), 30)
    tail = (st.latitudes, st.longitudes, nb, fl, "log", fr, "cheby1", 2, 0.01)
    _equal(TO.narrow_band_least_squares_oracle(wl, 0.5, alpha, _tstream(st), *tail),
           JO.narrow_band_least_squares_oracle(wl, 0.5, alpha, st, *tail), "oracle")


def test_port_pipeline_against_its_oracle(small_stream):
    """Mirror of ``test_jax_pipeline.py:183`` on the port: the API on the
    CPU against the port's oracle, at that test's tolerances."""
    st = small_stream
    fl, nb, _ = get_freqlist(0.2, 1.6, "log", 3)
    wl = get_winlenlist("adaptive", nb, 30, 40, 20)
    fr = np.logspace(-2, np.log10(st.fs / 2), 60)
    o = TO.narrow_band_least_squares_oracle(wl, 0.5, 1.0, _tstream(st), st.latitudes,
                                            st.longitudes, nb, fl, "log", fr, "cheby1", 2,
                                            0.01)
    g = tapi.narrow_band_least_squares(wl, 0.5, 1.0, _tstream(st), st.latitudes,
                                       st.longitudes, nb, None, None, fl, "log", fr,
                                       "cheby1", 2, 0.01, device="cpu")
    vel_o, baz_o, mdccm_o, t_o, _, sig_o, num_o, w_o, h_o = o
    vel_g, baz_g, mdccm_g, t_g, stdict_g, sig_g, num_g, w_g, h_g = g
    assert stdict_g is None and list(num_g) == list(num_o)
    np.testing.assert_allclose(w_g, w_o)
    np.testing.assert_allclose(h_g, h_o)
    for b in range(nb):
        n = num_g[b]
        np.testing.assert_allclose(t_g[b, :n], t_o[b, :n], atol=1e-9)
        np.testing.assert_allclose(mdccm_g[b, :n], mdccm_o[b, :n], atol=1e-2)
        d = np.abs((baz_g[b, :n] - baz_o[b, :n] + 180.0) % 360.0 - 180.0)
        assert np.quantile(d, 0.9) < 1.0, f"band {b}"
        assert np.median(np.abs(vel_g[b, :n] - vel_o[b, :n])) < 1e-2
