"""PyTorch port: the OLS narrow-band pipeline and API against the JAX package.

The same stream goes through the JAX ``NarrowBandPipeline.run_raw`` and the
port's on the CPU (kernels' plain versions).  vel/baz/MdCCM/sig_tau must
agree within 1e-4 (rtol and atol) on every window: no lag flips between
the two FFT libraries showed up on these inputs, so no window is excused.
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from narrow_band_least_squares_tpu import api as japi
from narrow_band_least_squares_tpu.models.narrowband import NarrowBandPipeline as JPipe
from narrow_band_least_squares_tpu.utils.geometry import get_rij
from narrow_band_least_squares_tpu.utils.plan import (
    get_freqlist, get_winlenlist, make_plan,
)
from narrow_band_least_squares_tpu_torch import api as tapi
from narrow_band_least_squares_tpu_torch.io.stream import ArrayStream as TStream
from narrow_band_least_squares_tpu_torch.models.narrowband import NarrowBandPipeline as TPipe
from narrow_band_least_squares_tpu_torch.state import state_from_numpy
from narrow_band_least_squares_tpu_torch.utils import plan as tplan

OUTS = ("vel", "baz", "mdccm", "sig_tau", "vel_uncert", "baz_uncert")


def _plans(st, nbands, kind):
    hi = 1.2 if nbands == 2 else 1.5
    fl, nb, _ = get_freqlist(0.3, hi, "log", nbands)
    if kind == "constant":
        wl = get_winlenlist("constant", nb, 30, 0, 0)
    else:
        wl = get_winlenlist("adaptive", nb, 0, 40, 20)
    return (make_plan(fl, "log", wl, 0.5, st.npts, st.fs),
            tplan.make_plan(fl, "log", wl, 0.5, st.npts, st.fs))


def _close(got, want, keys=OUTS[:4]):
    for k in keys:
        g = got[k].numpy() if isinstance(got[k], torch.Tensor) else got[k]
        np.testing.assert_allclose(g, np.asarray(want[k]), rtol=1e-4,
                                   atol=1e-4, err_msg=k)


CASES = [
    ("2band-constant", 2, "constant", {}),
    ("4band-adaptive", 4, "adaptive", {}),
    ("4band-adaptive-maxlag", 4, "adaptive", {"max_lag_s": 1.5}),
    ("4band-bandlimit-auto", 4, "adaptive", {"band_limit_db": "auto"}),
    ("4band-pallas", 4, "adaptive", {"xcorr_method": "pallas"}),
    ("4band-pallas-maxlag", 4, "adaptive", {"xcorr_method": "pallas", "max_lag_s": 1.5}),
    ("4band-gather-unbucketed", 4, "adaptive",
     {"window_method": "gather", "bucket_bands": False}),
    ("4band-strided-unbucketed", 4, "adaptive", {"bucket_bands": False}),
]


@pytest.mark.parametrize("name,nbands,kind,kw", CASES, ids=[c[0] for c in CASES])
def test_run_raw_matches_jax(small_stream, name, nbands, kind, kw):
    st = small_stream
    jp, tp = _plans(st, nbands, kind)
    rij = get_rij(st.latitudes, st.longitudes, st.nchans)
    want = JPipe(jp, rij, **kw).run_raw(st.data)
    pipe = TPipe(tp, rij, device="cpu", **kw)
    if kind == "adaptive" and kw.get("bucket_bands", True):
        assert len(pipe._buckets) > 1
    _close(pipe.run_raw(st.data), want, OUTS)


def test_run_and_batch_match_jax(small_stream):
    st = small_stream
    jp, tp = _plans(st, 4, "adaptive")
    rij = get_rij(st.latitudes, st.longitudes, st.nchans)
    fr = np.logspace(-2, np.log10(st.fs / 2), 30)
    jpipe, tpipe = JPipe(jp, rij), TPipe(tp, rij, device="cpu")
    a = jpipe.run(st, freq_resp_list=fr)
    b = tpipe.run(st, freq_resp_list=fr)
    for k in ("vel_array", "baz_array", "mdccm_array", "sig_tau_array"):
        np.testing.assert_allclose(getattr(b, k), getattr(a, k), rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(b.t_array, a.t_array)
    np.testing.assert_array_equal(b.h_array, a.h_array)
    assert b.num_compute_list == a.num_compute_list and b.stdict() is None
    x = np.stack([st.data, st.data[:, ::-1].copy()])
    _close(tpipe.run_batch_raw(x), jpipe.run_batch_raw(x))


def _jax_state(p, method="mxu"):
    """The JAX pipeline's constants under the port's state names."""
    d = {"h_bank": p._h_bank, "taper": p._taper, "X": p._X, "pinv": p._pinv,
         "XtX_inv": p._XtX_inv, "win_mask": p._win_mask,
         "bucket_inv_perm": p._bucket_inv_perm}
    if p.alpha < 1.0:
        d.update(cand=p._cand, Ainv=p._Ainv, cand_ok=p._cand_ok)
    if method == "fused":
        # the one-hot pair selections sbi/sbj have no port counterpart
        for i, bk in enumerate(p._fused_buckets):
            for k in ("Cf", "Sf", "Ec", "Es"):
                d[f"bucket{i}.{k}"] = bk["tables"][k]
            for k in ("hop", "maxstart", "lo", "hi", "len_mask"):
                d[f"bucket{i}.{k}"] = bk[k]
        return {k: np.asarray(v) for k, v in d.items()}
    tabs = ("Cf", "Sf", "Ec", "Es") if method == "mxu" else ("Cf", "Sf", "e2", "lo", "hi")
    for i, bk in enumerate(p._buckets):
        for k in tabs:
            d[f"bucket{i}.{k}"] = bk["tables"][k]
        for k in ("len_mask", "lengths") + (("lag_mask",) if method == "mxu" else ()):
            d[f"bucket{i}.{k}"] = bk[k]
    return {k: np.asarray(v) for k, v in d.items()}


@pytest.mark.parametrize("method", ["mxu", "pallas"])
def test_state_reproduces_jax_constants(small_stream, method):
    st = small_stream
    jp, tp = _plans(st, 4, "adaptive")
    rij = get_rij(st.latitudes, st.longitudes, st.nchans)
    jpipe = JPipe(jp, rij, xcorr_method=method, max_lag_s=1.5)
    tpipe = TPipe(tp, rij, device="cpu", xcorr_method=method, max_lag_s=1.5)
    jstate = _jax_state(jpipe, method)
    own = tpipe.state_dict()
    assert set(own) == set(jstate)
    for k, v in jstate.items():
        np.testing.assert_allclose(own[k].numpy().astype(np.float64),
                                   v.astype(np.float64), rtol=0, atol=1e-7,
                                   err_msg=k)
    before = tpipe.run_raw(st.data)
    loaded = TPipe(tp, rij, device="cpu", xcorr_method=method, max_lag_s=1.5)
    loaded.load_state(state_from_numpy(jstate))
    after = loaded.run_raw(st.data)
    for k in OUTS:
        torch.testing.assert_close(after[k], before[k], rtol=0, atol=0,
                                   equal_nan=True)
    _close(after, jpipe.run_raw(st.data))
    with pytest.raises(KeyError):
        loaded.load_state({})


def _tstream(st):
    return TStream(data=st.data, fs=st.fs, start_epoch=st.start_epoch,
                   latitudes=list(st.latitudes), longitudes=list(st.longitudes))


def test_api_matches_jax(small_stream):
    st = small_stream
    fl, nb, _ = get_freqlist(0.3, 1.5, "log", 4)
    wl = get_winlenlist("adaptive", nb, 0, 40, 20)
    fr = np.logspace(-2, np.log10(st.fs / 2), 30)
    args = (wl, 0.5, 1.0)
    tail = (st.latitudes, st.longitudes, nb, None, None, fl, "log", fr,
            "cheby1", 2, 0.01)
    want = japi.narrow_band_least_squares(*args, st, *tail)
    got = tapi.narrow_band_least_squares(*args, _tstream(st), *tail, device="cpu")
    for i in (0, 1, 2, 5):
        np.testing.assert_allclose(got[i], want[i], rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(got[3], want[3])
    assert got[4] is None and want[4] is None
    assert got[6] == want[6]
    np.testing.assert_array_equal(got[8], want[8])
    par = tapi.narrow_band_least_squares_parallel(*args, _tstream(st), *tail,
                                                  device="cpu")
    np.testing.assert_array_equal(par[0], got[0])


@pytest.mark.parametrize("ftype", ["cheby1", "butter"])
def test_filter_data_and_ltsva_match_jax(small_stream, ftype):
    st = small_stream
    fj, fsj, sosj = japi.filter_data(st, ftype, 0.3, 1.5, 2, 0.01)
    ft, fst, sost = tapi.filter_data(_tstream(st), ftype, 0.3, 1.5, 2, 0.01,
                                     device="cpu")
    np.testing.assert_array_equal(sost, sosj)
    assert np.all(np.abs(ft.data - fj.data) <= 1e-5 * np.abs(fj.data).max())
    for conf in (None, 0.9):
        want = japi.ltsva(fj, st.latitudes, st.longitudes, 30, 0.5, 1.0, conf=conf)
        got = tapi.ltsva(ft, st.latitudes, st.longitudes, 30, 0.5, 1.0,
                         conf=conf, device="cpu")
        for i in (0, 1, 3, 5, 6, 7):
            np.testing.assert_allclose(got[i], want[i], rtol=1e-4, atol=1e-4)
        np.testing.assert_array_equal(got[2], want[2])
        assert got[4] is None and want[4] is None


def test_narrow_band_loop_matches_jax(small_stream):
    st = small_stream
    fl, nb, _ = get_freqlist(0.3, 1.5, "log", 2)
    wl = [30.0, 20.0]
    fr = np.logspace(-2, np.log10(st.fs / 2), 30)
    want = japi.narrow_band_loop(1, fl, "log", fr, st, "cheby1", 2, 0.01,
                                 st.latitudes, st.longitudes, wl, 0.5, 1.0, 30)
    got = tapi.narrow_band_loop(1, fl, "log", fr, _tstream(st), "cheby1", 2, 0.01,
                                st.latitudes, st.longitudes, wl, 0.5, 1.0, 30,
                                device="cpu")
    for i in (0, 1, 2, 6):
        np.testing.assert_allclose(got[i], want[i], rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(got[3], want[3])
    assert got[4] is None and got[5] is None
    assert int(got[7]) == int(want[7])


def test_performance_defaults_reach_the_pipeline(small_stream):
    st = small_stream
    prev = tapi.set_performance_defaults(**tapi.PRODUCTION_DEFAULTS)
    try:
        fl, nb, _ = get_freqlist(0.3, 1.5, "log", 4)
        wl = get_winlenlist("adaptive", nb, 0, 40, 20)
        plan = tplan.make_plan(fl, "log", wl, 0.5, st.npts, st.fs)
        rij = get_rij(st.latitudes, st.longitudes, st.nchans)
        pipe = tapi._get_pipeline(plan, rij, device="cpu")
        assert pipe.band_limit_db == "auto"
    finally:
        tapi.set_performance_defaults(
            **{k: None for k in tapi.PRODUCTION_DEFAULTS}, **prev)
    assert not tapi._PERF_DEFAULTS


@pytest.mark.parametrize("kw,same_as", [
    ({"dtype": torch.float64}, {}),
    ({"subsample_delays": True}, None),
    ({"window_method": "patches"}, {"bucket_bands": False}),
], ids=["float64", "subsample", "patches"])
def test_unported_options_raise(small_stream, kw, same_as):
    """The options the port once refused now run: each within 1e-4 of the
    JAX pipeline with the same option, and float64 (computed as float32)
    and 'patches' (bucketing off) bit for bit the port's run with
    ``same_as`` instead."""
    st = small_stream
    jp, tp = _plans(st, 2, "constant")
    rij = get_rij(st.latitudes, st.longitudes, st.nchans)
    jkw = dict(kw, dtype=jnp.float64) if "dtype" in kw else kw
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)   # JAX's float64 truncation
        want = JPipe(jp, rij, **jkw).run_raw(st.data)
    got = TPipe(tp, rij, device="cpu", **kw).run_raw(st.data)
    _close(got, want, OUTS)
    if same_as is not None:
        ref = TPipe(tp, rij, device="cpu", **same_as).run_raw(st.data)
        for k in ref:
            assert got[k].dtype == torch.float32 and torch.equal(got[k], ref[k]), k
