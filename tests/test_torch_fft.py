"""PyTorch port: the FFT cross-correlation (`ops.xcorr.cross_correlate`,
``xcorr_method='fft'``) against the JAX package's on the CPU.

Inputs are ``tests/test_xcorr_methods.py``'s window batch (known integer
delays injected in one cell) with a full and a per-band lag mask.  Lags
are exact; rho and MdCCM within 1e-5 (the xcorr tolerance).  The pipeline
with 'fft' (unbucketed, as in the JAX package) is held to the pipeline
tolerance 1e-4, alone and with merged arrays.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from narrow_band_least_squares_tpu.models.multiarray import MultiArrayPipeline as JMulti
from narrow_band_least_squares_tpu.models.narrowband import NarrowBandPipeline as JPipe
from narrow_band_least_squares_tpu.ops import xcorr as JXC
from narrow_band_least_squares_tpu.utils.geometry import get_rij, pair_indices
from narrow_band_least_squares_tpu.utils.plan import get_freqlist, get_winlenlist, make_plan
from narrow_band_least_squares_tpu_torch.models import MultiArrayPipeline, NarrowBandPipeline
from narrow_band_least_squares_tpu_torch.ops import xcorr as TXC
from narrow_band_least_squares_tpu_torch.ops.filters import next_pow2
from narrow_band_least_squares_tpu_torch.utils import plan as tplan

XTOL, TOL = 1e-5, 1e-4
KEYS = ("vel", "baz", "mdccm", "sig_tau", "vel_uncert", "baz_uncert")


@pytest.fixture(scope="module")
def window_batch():
    rng = np.random.default_rng(3)
    B, W, C, L = 2, 5, 4, 200
    win = rng.standard_normal((B, W, C, L))
    base = rng.standard_normal(L + 40)
    for c, d in enumerate([0, 3, -5, 10]):
        win[0, 0, c] = base[20 - d: 20 - d + L]
    win -= win.mean(axis=-1, keepdims=True)
    return win.astype(np.float32), pair_indices(C), L


@pytest.mark.parametrize("mask", ["full", "per-band"])
def test_cross_correlate_matches_jax(window_batch, mask):
    win, pairs, L = window_batch
    fs = 10.0
    lag_mask = np.ones((win.shape[0], 2 * L - 1), dtype=bool)
    if mask == "per-band":
        lag_mask[1] = np.abs(np.arange(-(L - 1), L)) <= 60
    nfft = next_pow2(2 * L)
    want = JXC.cross_correlate(jnp.asarray(win), jnp.asarray(pairs),
                               jnp.asarray(lag_mask), nfft, fs)
    got = TXC.cross_correlate(torch.from_numpy(win), torch.from_numpy(pairs).long(),
                              torch.from_numpy(lag_mask), nfft, fs)
    np.testing.assert_array_equal(np.rint(got[0].numpy() * fs),
                                  np.rint(np.asarray(want[0]) * fs))
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=XTOL, atol=XTOL)
    # the injected delays of cell (0, 0): pair (i, j) lags d_j - d_i
    d = np.array([0, 3, -5, 10])
    np.testing.assert_array_equal(np.rint(got[0][0, 0].numpy() * fs),
                                  [d[j] - d[i] for i, j in pairs])
    if mask == "per-band":
        assert np.all(np.abs(got[0][1].numpy() * fs) <= 60)


def test_cross_correlate_first_max_on_ties():
    """An exact tie resolves to the smallest lag, as ``jnp.argmax``."""
    L = 16
    win = np.zeros((1, 1, 2, L), dtype=np.float32)
    win[0, 0, 0, 5] = 1.0
    win[0, 0, 1, [2, 8]] = 1.0            # equal peaks at lags -3 and +3
    lag_mask = np.ones((1, 2 * L - 1), dtype=bool)
    pairs = np.array([[0, 1]])
    got = TXC.cross_correlate(torch.from_numpy(win), torch.from_numpy(pairs),
                              torch.from_numpy(lag_mask), 32, 1.0)
    want = JXC.cross_correlate(jnp.asarray(win), jnp.asarray(pairs),
                               jnp.asarray(lag_mask), 32, 1.0)
    assert got[0].item() == np.asarray(want[0]).item() == -3.0


def _plans(st):
    freqlist, nbands, _ = get_freqlist(0.3, 1.5, "log", 3)
    winlens = get_winlenlist("adaptive", nbands, 30, 40, 20)
    args = (freqlist, "log", winlens, 0.5, st.npts, st.fs)
    return make_plan(*args), tplan.make_plan(*args)


@pytest.mark.parametrize("window_method", ["strided", "gather"])
@pytest.mark.parametrize("alpha", [1.0, 0.75], ids=["ols", "lts"])
def test_pipeline_fft_matches_jax(small_stream, window_method, alpha):
    st = small_stream
    jp, tp = _plans(st)
    rij = get_rij(st.latitudes, st.longitudes, st.nchans)
    kw = dict(xcorr_method="fft", window_method=window_method, alpha=alpha)
    want = JPipe(jp, rij, **kw).run_raw(st.data)
    pipe = NarrowBandPipeline(tp, rij, device="cpu", **kw)
    assert not pipe.bucket_bands and pipe.nfft_corr == next_pow2(2 * tp.max_winlensamp)
    got = pipe.run_raw(st.data)
    for k in KEYS:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=TOL,
                                   atol=TOL, err_msg=k)
    if alpha < 1.0:
        np.testing.assert_array_equal(got["flags"].numpy(), np.asarray(want["flags"]))


def test_multiarray_fft_matches_jax(small_stream):
    """Merged arrays through the FFT path (the JAX package's
    ``_delays_batched`` unbucketed branch)."""
    st = small_stream
    jp, tp = _plans(st)
    rij = get_rij(st.latitudes, st.longitudes, st.nchans)
    data = np.stack([st.data, st.data[::-1].copy()])
    want = JMulti(jp, [rij, rij], xcorr_method="fft").run_raw(data)
    got = MultiArrayPipeline(tp, [rij, rij], xcorr_method="fft", device="cpu").run_raw(data)
    for k in KEYS:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=TOL,
                                   atol=TOL, err_msg=k)


def test_fft_with_max_lag_is_refused(small_stream):
    """The JAX package fails on 'fft' with ``max_lag_s`` (its capped lag
    mask does not broadcast against the FFT's lags); the port refuses."""
    st = small_stream
    jp, tp = _plans(st)
    rij = get_rij(st.latitudes, st.longitudes, st.nchans)
    with pytest.raises(ValueError, match="Incompatible shapes"):
        JPipe(jp, rij, xcorr_method="fft", max_lag_s=5.0).run_raw(st.data)
    with pytest.raises(ValueError, match="max_lag_s"):
        NarrowBandPipeline(tp, rij, xcorr_method="fft", max_lag_s=5.0, device="cpu")
