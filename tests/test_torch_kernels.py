"""PyTorch port: icorr_peak's plain version against the JAX Pallas kernel.

The CUDA kernel runs only on the card, where ``chip_smoke.py`` holds it
against the same plain version.  Here the plain version (what a CPU tensor
gets) is held against ``icorr_peak(..., interpret=True)``: ``idx`` exact,
``peak`` within rtol 1e-5 (fp32 sums in another order).
"""

import numpy as np
import pytest
import torch

from narrow_band_least_squares_tpu.ops.kernels.xcorr_peak import icorr_peak as jax_icorr_peak
from narrow_band_least_squares_tpu_torch.ops.kernels import xcorr_peak as XP


def _jax(cs2, e2, lo, hi):
    import jax.numpy as jnp

    peak, idx = jax_icorr_peak(
        jnp.asarray(cs2), jnp.asarray(e2), jnp.asarray(lo[:, None]),
        jnp.asarray(hi[:, None]), e2.shape[1], interpret=True,
    )
    return np.asarray(peak), np.asarray(idx)


def _port(cs2, e2, lo, hi):
    peak, idx = XP.icorr_peak(*(torch.from_numpy(a) for a in (cs2, e2, lo, hi)))
    return peak.numpy(), idx.numpy()


@pytest.mark.parametrize("R,K2,nlag", [(77, 256, 131), (300, 128, 259), (5, 384, 1)])
def test_plain_matches_jax_kernel(R, K2, nlag):
    rng = np.random.default_rng(R + nlag)
    cs2 = rng.standard_normal((R, K2)).astype(np.float32)
    e2 = rng.standard_normal((K2, nlag)).astype(np.float32)
    half = nlag // 2
    bh = rng.integers(0, half + 1, R)
    lo = (half - bh).astype(np.int32)
    hi = (half + bh).astype(np.int32)
    pj, ij = _jax(cs2, e2, lo, hi)
    pt, it = _port(cs2, e2, lo, hi)
    np.testing.assert_array_equal(it, ij)
    np.testing.assert_allclose(pt, pj, rtol=1e-5, atol=1e-5)


def test_first_max_wins_across_tiles():
    """Equal maxima at lags 5, 130 and 299 (three 128-lag tiles of the JAX
    kernel); integer inputs make every sum exact, so the ties are exact in
    both versions and the first lag a row searches must win."""
    rng = np.random.default_rng(3)
    R, K2, nlag = 40, 128, 300
    cs2 = rng.integers(0, 4, (R, K2)).astype(np.float32)
    e2 = rng.integers(-3, 4, (K2, nlag)).astype(np.float32)
    col = rng.integers(20, 24, K2).astype(np.float32)
    for lag in (5, 130, 299):
        e2[:, lag] = col
    lo = rng.integers(0, 300, R).astype(np.int32)
    hi = np.full(R, nlag - 1, np.int32)
    want = np.where(lo <= 5, 5, np.where(lo <= 130, 130, 299))
    cs2[0] = 1.0  # keep one row with a strictly positive tie
    pj, ij = _jax(cs2, e2, lo, hi)
    pt, it = _port(cs2, e2, lo, hi)
    np.testing.assert_array_equal(ij, want)
    np.testing.assert_array_equal(it, want)
    np.testing.assert_array_equal(pt, pj)


def test_empty_lag_range_gives_neg_inf_and_zero():
    cs2 = np.ones((3, 128), np.float32)
    e2 = np.ones((128, 10), np.float32)
    lo = np.array([2, 5, 0], np.int32)
    hi = np.array([1, 4, 9], np.int32)
    pj, ij = _jax(cs2, e2, lo, hi)
    pt, it = _port(cs2, e2, lo, hi)
    np.testing.assert_array_equal(it, ij)
    np.testing.assert_array_equal(pt, pj)
    assert np.isneginf(pt[:2]).all() and (it[:2] == 0).all()


def test_cpu_tensors_take_the_plain_version_and_count_nothing():
    before = XP.launches
    cs2 = torch.randn(4, 128)
    e2 = torch.randn(128, 7)
    lo = torch.zeros(4, dtype=torch.int32)
    hi = torch.full((4,), 6, dtype=torch.int32)
    p, i = XP.icorr_peak(cs2, e2, lo, hi)
    pr, ir = XP.icorr_peak_reference(cs2, e2, lo, hi)
    assert torch.equal(p, pr) and torch.equal(i, ir)
    assert XP.launches == before
    assert XP._bound is None   # nothing was built or loaded


@pytest.mark.parametrize("bad", ["dtype", "index_dtype", "shape", "bounds", "device"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    cs2 = torch.randn(4, 128)
    e2 = torch.randn(128, 7)
    lo = torch.zeros(4, dtype=torch.int32)
    hi = torch.full((4,), 6, dtype=torch.int32)
    if bad == "dtype":
        cs2 = cs2.double()
    elif bad == "index_dtype":
        lo = lo.long()
    elif bad == "shape":
        e2 = torch.randn(64, 7)
    elif bad == "bounds":
        hi = hi[:3]
    else:
        cs2, e2, lo, hi = (t.to("meta") for t in (cs2, e2, lo, hi))
    with pytest.raises((TypeError, ValueError)):
        XP.icorr_peak(cs2, e2, lo, hi)
