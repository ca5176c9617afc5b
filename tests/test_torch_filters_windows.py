"""PyTorch port: filter bank and window extraction against the JAX package.

``filter_bank_fft`` must agree within 1e-5 of each band's peak (two FFT
libraries, float32).  The extractors must agree within 1e-6 on every valid
window; padded window slots (w >= n_windows) differ between extractors by
design and are hidden by ``win_mask`` downstream.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from narrow_band_least_squares_tpu.ops import filters as JF
from narrow_band_least_squares_tpu.ops import windows as JW
from narrow_band_least_squares_tpu.utils.plan import (
    get_freqlist, get_winlenlist, make_plan,
)
from narrow_band_least_squares_tpu_torch.ops import filters as TF
from narrow_band_least_squares_tpu_torch.ops import windows as TW
from narrow_band_least_squares_tpu_torch.utils import plan as tplan


@pytest.mark.parametrize("filter_type", ["cheby1", "butter"])
def test_filter_bank_matches_jax(filter_type):
    fs, T = 10.0, 1200
    x = np.random.default_rng(1).standard_normal((3, T)).astype(np.float32)
    edges = [(0.3, 0.6), (0.6, 1.2), (1.2, 2.4)]
    h_bank, sos, L = JF.build_filter_bank(edges, filter_type, 2, 0.01, fs, T)
    h2, sos2, L2 = TF.build_filter_bank(edges, filter_type, 2, 0.01, fs, T)
    np.testing.assert_array_equal(h_bank, h2)
    assert L == L2
    nfft = JF.next_pow2(T + L)
    taper = JF.taper_window(T)
    np.testing.assert_array_equal(taper, TF.taper_window(T))
    zp = filter_type == "butter"
    want = np.asarray(JF.filter_bank_fft(
        jnp.asarray(x), jnp.asarray(h_bank, jnp.float32),
        jnp.asarray(taper, jnp.float32), nfft, zp,
    ))
    got = TF.filter_bank_fft(
        torch.from_numpy(x), torch.from_numpy(h_bank.astype(np.float32)),
        torch.from_numpy(taper.astype(np.float32)), nfft, zp,
    ).numpy()
    assert got.shape == want.shape == (3, 3, T)
    peak = np.abs(want).max(axis=(1, 2), keepdims=True)
    assert np.all(np.abs(got - want) <= 1e-5 * peak)


def test_sosfreqz_bank_equals_jax():
    sos = [JF.design_sos("cheby1", 0.3, 0.6, 2, 0.01, 10.0)]
    fr = np.logspace(-2, np.log10(5.0), 50)
    for a, b in zip(JF.sosfreqz_bank(sos, fr, 10.0), TF.sosfreqz_bank(sos, fr, 10.0)):
        np.testing.assert_array_equal(a, b)


def _plan(adaptive=True):
    fs, T = 10.0, 900
    fl, nb, _ = get_freqlist(0.3, 1.5, "log", 4)
    wl = (get_winlenlist("adaptive", nb, 0, 40, 20) if adaptive
          else get_winlenlist("constant", nb, 30, 0, 0))
    return (make_plan(fl, "log", wl, 0.5, T, fs),
            tplan.make_plan(fl, "log", wl, 0.5, T, fs))


def _y(plan):
    rng = np.random.default_rng(5)
    return rng.standard_normal((plan.nbands, 3, plan.npts)).astype(np.float32)


def test_grids_equal_jax():
    jp, tp = _plan()
    a, b = JW.build_window_grid(jp), TW.build_window_grid(tp)
    for k in ("idx", "win_mask", "len_mask", "lengths", "lag_mask"):
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k))
    for max_lag in (None, 7):
        ga = JW.build_bucket_grids(jp, max_lag=max_lag)
        gb = TW.build_bucket_grids(tp, max_lag=max_lag)
        assert len(ga) == len(gb) > 1
        for x, y in zip(ga, gb):
            for k in ("band_idx", "idx", "len_mask", "lengths", "lag_mask"):
                np.testing.assert_array_equal(getattr(x, k), getattr(y, k))


@pytest.mark.parametrize("method", ["strided", "gather"])
def test_bucket_extractors_match_jax(method):
    jp, tp = _plan()
    y = _y(jp)
    for g in TW.build_bucket_grids(tp):
        lm = torch.from_numpy(g.len_mask.astype(np.float32))
        ln = torch.from_numpy(g.lengths.astype(np.float32))
        want = np.asarray(JW.extract_windows_strided_bucket(
            jnp.asarray(y), jp.windows, g, jnp.asarray(lm.numpy()),
            jnp.asarray(ln.numpy()),
        ))
        if method == "strided":
            got = TW.extract_windows_strided_rows(
                torch.from_numpy(y), g.band_idx,
                [tp.windows[int(b)].hop for b in g.band_idx], g.Wmax, g.Lmax,
                lm, ln).numpy()
        else:
            got = TW.extract_windows(
                torch.from_numpy(y[g.band_idx]), torch.from_numpy(g.idx),
                lm, ln).numpy()
        for gi, b in enumerate(g.band_idx):
            n = tp.windows[int(b)].n_windows
            np.testing.assert_allclose(got[gi, :n], want[gi, :n], rtol=0, atol=1e-6)


def test_global_extractors_match_jax():
    jp, tp = _plan(adaptive=False)
    y = _y(jp)
    grid = JW.build_window_grid(jp)
    lm = grid.len_mask.astype(np.float32)
    ln = grid.lengths.astype(np.float32)
    want = np.asarray(JW.extract_windows(jnp.asarray(y), jnp.asarray(grid.idx),
                                         jnp.asarray(lm), jnp.asarray(ln)))
    got_s = TW.extract_windows_strided(torch.from_numpy(y), tp,
                                       torch.from_numpy(lm), torch.from_numpy(ln))
    got_g = TW.extract_windows(torch.from_numpy(y), torch.from_numpy(grid.idx),
                               torch.from_numpy(lm), torch.from_numpy(ln))
    for b, wp in enumerate(tp.windows):
        n = wp.n_windows
        np.testing.assert_allclose(got_s.numpy()[b, :n], want[b, :n], atol=1e-6, rtol=0)
        np.testing.assert_allclose(got_g.numpy()[b, :n], want[b, :n], atol=1e-6, rtol=0)


def test_mask_demean_matches_jax():
    rng = np.random.default_rng(2)
    win = rng.standard_normal((2, 3, 4, 16)).astype(np.float32)
    lm = np.zeros((2, 1, 1, 16), np.float32)
    lm[0, ..., :16] = 1
    lm[1, ..., :9] = 1
    ln = np.array([16, 9], np.float32)
    want = np.asarray(JW.mask_demean(jnp.asarray(win), jnp.asarray(lm), jnp.asarray(ln)))
    got = TW.mask_demean(torch.from_numpy(win), torch.from_numpy(lm),
                         torch.from_numpy(ln)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
