"""PyTorch port: xcorr_method='fused' against the JAX package.

The CUDA kernel runs only on the card, where ``chip_smoke.py`` holds it
against the plain version.  Here the plain version (what a CPU tensor gets)
is held against the JAX Pallas kernel in interpret mode, and the port's
fused pipeline against the JAX one:

- kernel level, JAX at ``precision=HIGHEST`` (IEEE fp32, as the port
  computes): ``idx`` exact, ``rho`` within 1e-5;
- kernel level, JAX at its default ``HIGH`` (bf16x3 split products): ``idx``
  exact and ``rho`` within 2e-5, the MdCCM tolerance of the JAX package's
  own fused test (``tests/test_xcorr_methods.py:422``);
- pipeline level 1e-4 on every output.  With ``max_lag_s`` the JAX run is at
  ``matmul_precision='highest'``: at 'high' the JAX fused kernel itself
  moves one near-tied lag (an MdCCM 0.38 window of ``small_stream``) away
  from the JAX 'mxu' path, which the port matches.
"""

import logging

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from narrow_band_least_squares_tpu.models.narrowband import NarrowBandPipeline as JPipe
from narrow_band_least_squares_tpu.ops.kernels import fused_xcorr as JFX
from narrow_band_least_squares_tpu.utils.geometry import get_rij
from narrow_band_least_squares_tpu.utils.plan import make_plan
from narrow_band_least_squares_tpu_torch.models.narrowband import NarrowBandPipeline as TPipe
from narrow_band_least_squares_tpu_torch.ops.kernels import fused_xcorr as FX
from narrow_band_least_squares_tpu_torch.state import state_from_numpy
from narrow_band_least_squares_tpu_torch.utils import plan as tplan

from test_torch_pipeline import OUTS, _close, _jax_state, _plans

PAIRS = np.array([(i, j) for i in range(4) for j in range(i + 1, 4)], np.int32)


@pytest.mark.parametrize("max_lag", [None, 9])
def test_tables_match_jax(max_lag):
    Lg = 150
    want = JFX.precompute_fused_tables(Lg, PAIRS, 4, max_lag=max_lag)
    got = FX.precompute_fused_tables(Lg, PAIRS, 4, max_lag=max_lag)
    for k in ("Cf", "Sf", "Ec", "Es"):
        assert got[k].shape == want[k].shape and got[k].dtype == np.float32
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-7, err_msg=k)
    for k in ("lag_min", "nlag", "K"):
        assert got[k] == want[k]
    onehot = lambda c: np.eye(4, dtype=np.float32)[PAIRS[:, c]]
    eye = np.eye(want["Wt"], dtype=np.float32)
    np.testing.assert_array_equal(want["sbi"], np.kron(eye, onehot(0)))
    np.testing.assert_array_equal(want["sbj"], np.kron(eye, onehot(1)))
    with pytest.raises(ValueError):
        FX.precompute_fused_tables(Lg, PAIRS, 3)


def _bucket(max_lag, seed=5):
    """A ragged 3-band bucket: lengths 48/45/41, hops 12/11/10 and 33
    windows, so each band's last windows are clamped to its own T - Lb."""
    rng = np.random.default_rng(seed)
    Bg, C, T, Lg, W = 3, 4, 400, 48, 33
    lengths = np.array([48, 45, 41])
    y = rng.standard_normal((Bg, C, T)).astype(np.float32)
    len_mask = (np.arange(Lg)[None, :] < lengths[:, None]).astype(np.float32)
    half = Lg - 1 if max_lag is None else max_lag
    bh = np.minimum(lengths - 1, half)
    col = lambda v: np.asarray(v, np.int32)[:, None]
    ins = dict(y=y, hop=col([12, 11, 10]), maxstart=col(T - lengths),
               lo=col(half - bh), hi=col(half + bh), len_mask=len_mask)
    return ins, W


@pytest.mark.parametrize("precision", ["highest", "high"])
@pytest.mark.parametrize("max_lag", [None, 9])
def test_reference_matches_jax_kernel(precision, max_lag):
    ins, W = _bucket(max_lag)
    jt = JFX.precompute_fused_tables(48, PAIRS, 4, max_lag=max_lag)
    prec = {"highest": jax.lax.Precision.HIGHEST, "high": jax.lax.Precision.HIGH}
    rj, ij = JFX.fused_xcorr_bucket(
        *(jnp.asarray(ins[k]) for k in ("y", "hop", "maxstart", "lo", "hi", "len_mask")),
        *(jnp.asarray(jt[k]) for k in ("Cf", "Sf", "Ec", "Es", "sbi", "sbj")),
        Wmax=W, T=ins["y"].shape[2], interpret=True, precision=prec[precision],
    )
    tt = {k: torch.from_numpy(v) for k, v in ins.items()}
    tab = FX.precompute_fused_tables(48, PAIRS, 4, max_lag=max_lag)
    rt, it = FX.fused_xcorr_bucket(
        *(tt[k] for k in ("y", "hop", "maxstart", "lo", "hi", "len_mask")),
        *(torch.from_numpy(tab[k]) for k in ("Cf", "Sf", "Ec", "Es")),
        torch.from_numpy(PAIRS), W,
    )
    assert rt.shape == it.shape == (3, W, len(PAIRS))
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij)[:, :W])
    tol = 1e-5 if precision == "highest" else 2e-5
    np.testing.assert_allclose(rt.numpy(), np.asarray(rj)[:, :W], rtol=tol, atol=tol)


RUN_CASES = [
    ("highest", {}),
    ("highest", {"max_lag_s": 1.5}),
    ("high", {}),
]


@pytest.mark.parametrize("precision,kw", RUN_CASES,
                         ids=["highest", "highest-maxlag", "high"])
def test_run_raw_matches_jax(small_stream, precision, kw):
    st = small_stream
    jp, tp = _plans(st, 4, "adaptive")
    rij = get_rij(st.latitudes, st.longitudes, st.nchans)
    want = JPipe(jp, rij, xcorr_method="fused", matmul_precision=precision,
                 **kw).run_raw(st.data)
    pipe = TPipe(tp, rij, xcorr_method="fused", device="cpu", **kw)
    assert pipe.bucket_bands and len(pipe._buckets) > 1
    _close(pipe.run_raw(st.data), want, OUTS)


def test_bucketing_is_forced_on(small_stream):
    st = small_stream
    _, tp = _plans(st, 4, "adaptive")
    rij = get_rij(st.latitudes, st.longitudes, st.nchans)
    pipe = TPipe(tp, rij, xcorr_method="fused", bucket_bands=False, device="cpu")
    assert pipe.bucket_bands and "bucket0.hop" in pipe.state_dict()


def _mixed_fixture():
    """The mixed-length bucket of ``tests/test_xcorr_methods.py:457``: one
    bucket of a 30 s and a 29 s band, the short band's last window starting
    past T - Lg."""
    from narrow_band_least_squares_tpu.io.synthetic import synthetic_plane_wave

    st = synthetic_plane_wave(
        nchans=5, duration_s=300, fs=10.0, baz_deg=200.0,
        trace_vel_kms=0.33, f0=0.6, bandwidth=0.8, snr=10, seed=3,
    )
    args = ([0.3, 0.7, 1.4], "linear", [30, 29], 0.95, st.npts, st.fs)
    rij = get_rij(st.latitudes, st.longitudes, st.nchans)
    return st, make_plan(*args), tplan.make_plan(*args), rij


def test_mixed_length_bucket_last_windows():
    """Mirror of ``test_xcorr_methods.py:443``: the port's fused run equals
    the JAX 'mxu' run at that test's tolerances (vel 1e-5, MdCCM 2e-5)."""
    st, jp, tp, rij = _mixed_fixture()
    kw = dict(filter_type="cheby1", alpha=1.0, bucket_slack=4.0)
    pf = TPipe(tp, rij, xcorr_method="fused", device="cpu", **kw)
    assert len(pf._buckets) == 1
    Lg = max(wp.winlensamp for wp in tp.windows)
    wp = min(tp.windows, key=lambda w: w.winlensamp)
    assert wp.winlensamp < Lg and wp.starts[-1] > tp.npts - Lg
    maxstart = pf.state_dict()["bucket0.maxstart"].ravel().tolist()
    assert sorted(maxstart) == sorted(tp.npts - w.winlensamp for w in tp.windows)
    rm = JPipe(jp, rij, **kw).run_raw(st.data)
    rf = pf.run_raw(st.data)
    np.testing.assert_allclose(rf["vel"].numpy(), np.asarray(rm["vel"]), atol=1e-5)
    np.testing.assert_allclose(rf["mdccm"].numpy(), np.asarray(rm["mdccm"]), atol=2e-5)


def test_multiarray_merge(small_stream):
    """Mirror of ``test_xcorr_methods.py:483``: two arrays merged into one
    fused launch per bucket give each array's own result."""
    st = small_stream
    _, tp = _plans(st, 4, "adaptive")
    rij = get_rij(st.latitudes, st.longitudes, st.nchans)
    pf = TPipe(tp, rij, xcorr_method="fused", device="cpu")
    x = [pf._to_device(st.data), pf._to_device(st.data[:, ::-1].copy())]
    before = FX.launches
    tau, rho, md = pf._delays_batched(torch.stack([pf._filter(v) for v in x]))
    assert FX.launches == before   # CPU tensors: the plain version, uncounted
    for a in range(2):
        t1, r1, m1 = pf._delays(pf._filter(x[a]))
        np.testing.assert_allclose(tau[a].numpy(), t1.numpy(), atol=1e-5)
        np.testing.assert_allclose(rho[a].numpy(), r1.numpy(), atol=1e-5)
        np.testing.assert_allclose(md[a].numpy(), m1.numpy(), atol=1e-5)
    rb = pf.run_batch_raw(np.stack([st.data, st.data[:, ::-1]]))
    np.testing.assert_allclose(rb["vel"][0].numpy(), pf.run_raw(st.data)["vel"].numpy(),
                               atol=1e-5)


def test_state_carried_across_is_bit_identical(small_stream):
    st = small_stream
    jp, tp = _plans(st, 4, "adaptive")
    rij = get_rij(st.latitudes, st.longitudes, st.nchans)
    kw = dict(xcorr_method="fused", max_lag_s=1.5)
    jstate = _jax_state(JPipe(jp, rij, **kw), "fused")
    own = TPipe(tp, rij, device="cpu", **kw)
    assert set(own.state_dict()) == set(jstate)
    for k, v in jstate.items():
        np.testing.assert_allclose(own.state_dict()[k].numpy().astype(np.float64),
                                   v.astype(np.float64), rtol=0, atol=1e-7, err_msg=k)
    loaded = TPipe(tp, rij, device="cpu", **kw)
    loaded.load_state(state_from_numpy(jstate))
    before, after = own.run_raw(st.data), loaded.run_raw(st.data)
    for k in OUTS:
        torch.testing.assert_close(after[k], before[k], rtol=0, atol=0, equal_nan=True)


@pytest.mark.parametrize("method", ["pallas", "fused"])
def test_subsample_delays_warns_and_is_ignored(small_stream, caplog, method):
    st = small_stream
    _, tp = _plans(st, 2, "constant")
    rij = get_rij(st.latitudes, st.longitudes, st.nchans)
    with caplog.at_level(logging.WARNING, logger="nbls_torch"):
        sub = TPipe(tp, rij, xcorr_method=method, subsample_delays=True, device="cpu")
    assert "subsample_delays is ignored" in caplog.text
    plain = TPipe(tp, rij, xcorr_method=method, device="cpu")
    a, b = sub.run_raw(st.data), plain.run_raw(st.data)
    for k in OUTS:
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0, equal_nan=True)


def _small_args():
    ins, W = _bucket(None)
    tab = FX.precompute_fused_tables(48, PAIRS, 4)
    args = [torch.from_numpy(ins[k]) for k in ("y", "hop", "maxstart", "lo", "hi", "len_mask")]
    args += [torch.from_numpy(tab[k]) for k in ("Cf", "Sf", "Ec", "Es")]
    return args + [torch.from_numpy(PAIRS)], W


def test_cpu_tensors_take_the_plain_version_and_count_nothing():
    args, W = _small_args()
    before = FX.launches
    got = FX.fused_xcorr_bucket(*args, W)
    want = FX.fused_xcorr_bucket_reference(*args, W)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert FX.launches == before
    assert FX._bound is None   # nothing was built or loaded


@pytest.mark.parametrize("bad", ["dtype", "index_dtype", "pairs_dtype", "shape",
                                 "tables", "device"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    args, W = _small_args()
    if bad == "dtype":
        args[0] = args[0].double()
    elif bad == "index_dtype":
        args[1] = args[1].long()
    elif bad == "pairs_dtype":
        args[10] = args[10].long()
    elif bad == "shape":
        args[3] = args[3][:2]
    elif bad == "tables":
        args[8] = args[8][:-1]
    else:
        args = [t.to("meta") for t in args]
    with pytest.raises((TypeError, ValueError)):
        FX.fused_xcorr_bucket(*args, W)
