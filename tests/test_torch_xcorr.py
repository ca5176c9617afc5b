"""PyTorch port: cross-correlation against the JAX package.

The same windows go through the JAX ``cross_correlate_mxu`` and
``cross_correlate_pallas`` (interpreted), jitted as the JAX pipeline runs
them, and through the port's two functions on the CPU.  ``tau`` must be
exact: both compute ``lag * (1/fs)`` (a jitted division by a constant
multiplies by its reciprocal, and so does the port, on every device); rho
and MdCCM within 1e-5 (float32 sums in another order, and the port's single
stacked inverse-DFT product against JAX's two).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from narrow_band_least_squares_tpu.ops import xcorr as JXC
from narrow_band_least_squares_tpu.utils.geometry import pair_indices
from narrow_band_least_squares_tpu_torch.ops import xcorr as TXC


def _batch(C, seed=9):
    rng = np.random.default_rng(seed)
    B, W = 2, 4
    lengths = np.array([100, 60], dtype=np.int32)
    Lmax = int(lengths.max())
    win = rng.standard_normal((B, W, C, Lmax))
    for b, L in enumerate(lengths):
        win[b, :, :, L:] = 0.0
    win -= win.mean(axis=-1, keepdims=True) * (win != 0)
    pairs = pair_indices(C)
    lags = np.arange(-(Lmax - 1), Lmax)
    lag_mask = np.stack([np.abs(lags) <= L - 1 for L in lengths])
    return win.astype(np.float32), pairs, lag_mask, lengths, Lmax


def _jax_tables(tab):
    return {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
            for k, v in tab.items()}


def _torch_tables(tab):
    return {k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v)
            for k, v in tab.items()}


def _jit(fn, win, *args, **kw):
    """``fn(win, *args, **kw)`` jitted over the windows, the rest constants."""
    return jax.jit(lambda w: fn(w, *args, **kw))(jnp.asarray(win))


def _check(got, want):
    tau, rho, md = (t.numpy() for t in got)
    np.testing.assert_array_equal(tau, np.asarray(want[0]))
    np.testing.assert_allclose(rho, np.asarray(want[1]), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(md, np.asarray(want[2]), rtol=1e-5, atol=1e-5)


# C=4 gives P=6 pairs and C=5 P=10 (even: the median averages the two middle
# values), C=3 gives P=3 (odd)
@pytest.mark.parametrize("C", [4, 5, 3])
def test_mxu_matches_jax(C):
    win, pairs, lag_mask, lengths, Lmax = _batch(C)
    tab = JXC.precompute_dft_tables(Lmax, np.float32)
    want = _jit(JXC.cross_correlate_mxu, win, jnp.asarray(pairs),
                jnp.asarray(lag_mask), _jax_tables(tab), 10.0)
    got = TXC.cross_correlate_mxu(
        torch.from_numpy(win), torch.from_numpy(pairs).long(),
        torch.from_numpy(lag_mask), _torch_tables(tab), 10.0,
    )
    _check(got, want)


@pytest.mark.parametrize("C", [4, 5])
def test_pallas_matches_jax_mxu_and_pallas(C):
    win, pairs, lag_mask, lengths, Lmax = _batch(C, seed=C)
    tm = JXC.precompute_dft_tables(Lmax, np.float32)
    want_m = _jit(JXC.cross_correlate_mxu, win, jnp.asarray(pairs),
                  jnp.asarray(lag_mask), _jax_tables(tm), 10.0)
    tp = JXC.precompute_pallas_tables(Lmax, lengths)
    want_p = _jit(JXC.cross_correlate_pallas, win, jnp.asarray(pairs),
                  _jax_tables(tp), 10.0, interpret=True)
    got = TXC.cross_correlate_pallas(
        torch.from_numpy(win), torch.from_numpy(pairs).long(),
        _torch_tables(TXC.precompute_pallas_tables(Lmax, lengths)), 10.0,
    )
    _check(got, want_m)
    _check(got, want_p)


def test_mxu_with_lag_cap_matches_jax():
    win, pairs, lag_mask, lengths, Lmax = _batch(4, seed=2)
    half = 20
    c = Lmax - 1
    capped = lag_mask[:, c - half: c + half + 1]
    tab = JXC.precompute_dft_tables(Lmax, np.float32, max_lag=half)
    want = _jit(JXC.cross_correlate_mxu, win, jnp.asarray(pairs),
                jnp.asarray(capped), _jax_tables(tab), 10.0)
    got = TXC.cross_correlate_mxu(
        torch.from_numpy(win), torch.from_numpy(pairs).long(),
        torch.from_numpy(capped), _torch_tables(tab), 10.0,
    )
    _check(got, want)


@pytest.mark.parametrize("n", [1, 2, 6, 7, 28])
def test_median_is_jnp_median(n):
    x = np.random.default_rng(n).standard_normal((5, n)).astype(np.float32)
    np.testing.assert_array_equal(
        TXC.median_last(torch.from_numpy(x)).numpy(),
        np.asarray(jnp.median(jnp.asarray(x), axis=-1)),
    )


def test_host_tables_equal_jax():
    lengths = np.array([80, 51, 64])
    for a, b in ((JXC.precompute_dft_tables(80, np.float32, max_lag=30),
                  TXC.precompute_dft_tables(80, np.float32, max_lag=30)),
                 (JXC.precompute_pallas_tables(80, lengths),
                  TXC.precompute_pallas_tables(80, lengths))):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]))
    tab = JXC.precompute_dft_tables(64, np.float32)
    for x, y in zip(JXC.slice_tables_bins(tab, 3, 20).values(),
                    TXC.slice_tables_bins(tab, 3, 20).values()):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_subsample_raises():
    """``subsample=True``, once refused, against JAX's: tau within 2e-4
    samples (``tests/test_xcorr_methods.py:285``), rho and MdCCM within
    1e-5, on bands with their own lag ranges."""
    win, pairs, lag_mask, lengths, Lmax = _batch(4)
    tab = JXC.precompute_dft_tables(Lmax, np.float32)
    want = _jit(JXC.cross_correlate_mxu, win, jnp.asarray(pairs), jnp.asarray(lag_mask),
                _jax_tables(tab), 10.0, subsample=True)
    got = TXC.cross_correlate_mxu(
        torch.from_numpy(win), torch.from_numpy(pairs).long(),
        torch.from_numpy(lag_mask), _torch_tables(tab), 10.0, subsample=True,
    )
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=2e-4 / 10.0)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), rtol=1e-5, atol=1e-5)
