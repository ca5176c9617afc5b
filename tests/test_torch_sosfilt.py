"""PyTorch port: the exact time-domain SOS recurrence (`ops.filters.
sosfilt_scan`, `filter_stream_scan`, on the port's own kernel
`ops.kernels.sosfilt`) against the JAX package's ``lax.scan`` and against
``scipy.signal.sosfilt``.

The tolerance against scipy is ``tests/test_jax_pipeline.py:231``'s: 1e-3
of the peak in float32.  In float64 the plain version equals scipy to
1e-12 of the peak (the same order of operations).  Against JAX in float32
the port is bit for bit the compiled ``lax.scan``: it contracts the
products that XLA contracts (``ys = fma(b0, y, z1)``, ``z1 = fma(b1, y,
-(a1 ys)) + z2``, ``z2 = fma(b2, y, -(a2 ys))``, read from the optimized IR
by ``scripts/xla_contractions.py --sosfilt``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import signal

from narrow_band_least_squares_tpu.ops import filters as JF
from narrow_band_least_squares_tpu_torch.ops import filters as TF
from narrow_band_least_squares_tpu_torch.ops.kernels import sosfilt as SF

CASES = [("cheby1", 0.5, 2.0, 2), ("butter", 0.3, 1.2, 2), ("cheby1", 0.2, 4.0, 4),
         ("butter", 0.3, 1.2, 1)]


def _case(kind, lo, hi, order, shape=(3, 500), seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape)
    sos = JF.design_sos(kind, lo, hi, order, 0.01, 10.0)
    return x, sos


@pytest.mark.parametrize("case", CASES, ids=[f"{c[0]}-{c[3]}" for c in CASES])
def test_sosfilt_scan_matches_scipy_and_jax(case):
    """Mirror of ``test_jax_pipeline.py:231``, and the port against JAX."""
    x, sos = _case(*case)
    ref = signal.sosfilt(sos, x, axis=-1)
    scale = np.abs(ref).max()
    got = TF.sosfilt_scan(torch.tensor(sos, dtype=torch.float32),
                          torch.tensor(x, dtype=torch.float32)).numpy()
    assert np.abs(got - ref).max() < 1e-3 * scale
    want = np.asarray(JF.sosfilt_scan(jnp.asarray(sos, jnp.float32),
                                      jnp.asarray(x, jnp.float32)))
    np.testing.assert_array_equal(got, want)
    got64 = TF.sosfilt_scan(torch.tensor(sos), torch.tensor(x)).numpy()
    assert np.abs(got64 - ref).max() <= 1e-12 * scale


@pytest.mark.parametrize("zerophase", [False, True])
def test_filter_stream_scan_matches_jax(zerophase):
    """One band, the taper, and the finite two-pass zero-phase mode."""
    x, sos = _case("butter" if zerophase else "cheby1", 0.3, 1.2, 2, shape=(4, 800))
    taper = JF.taper_window(800, 0.01)
    want = np.asarray(JF.filter_stream_scan(jnp.asarray(x, jnp.float32),
                                            jnp.asarray(sos, jnp.float32),
                                            jnp.asarray(taper, jnp.float32), zerophase))
    got = TF.filter_stream_scan(torch.tensor(x, dtype=torch.float32),
                                torch.tensor(sos, dtype=torch.float32),
                                torch.tensor(taper, dtype=torch.float32), zerophase).numpy()
    np.testing.assert_array_equal(got, want)
    ref = signal.sosfilt(sos, x, axis=-1)
    if zerophase:
        ref = signal.sosfilt(sos, ref[..., ::-1], axis=-1)[..., ::-1]
    assert np.abs(got - ref * taper).max() < 1e-3 * np.abs(ref).max()


def test_scan_cross_checks_the_fft_filter_bank():
    """The reason the JAX package keeps the recurrence: the FFT filter
    bank's band equals the exact recurrence (its impulse response is cut at
    1e-7 of the peak)."""
    x, sos = _case("cheby1", 0.5, 2.0, 2, shape=(3, 1200))
    h = TF.impulse_response(sos, TF.impulse_length(sos, 1200))
    bank = TF.filter_bank_fft(torch.tensor(x, dtype=torch.float32),
                              torch.tensor(h[None], dtype=torch.float32), None,
                              TF.next_pow2(1200 + len(h)), False)[0].numpy()
    scan = TF.sosfilt_scan(torch.tensor(sos, dtype=torch.float32),
                           torch.tensor(x, dtype=torch.float32)).numpy()
    assert np.abs(bank - scan).max() < 1e-4 * np.abs(scan).max()


def test_wrapper_contract():
    """The CPU route is the plain version (batch axes kept); no launch is
    counted there; sos must be (S, 6); a tensor on another device raises."""
    x, sos = _case("cheby1", 0.5, 2.0, 2, shape=(2, 3, 100))
    xt, st = torch.tensor(x, dtype=torch.float32), torch.tensor(sos, dtype=torch.float32)
    before = SF.launches
    got = SF.sosfilt(st, xt)
    assert got.shape == xt.shape and SF.launches == before
    assert torch.equal(got, SF.sosfilt_reference(st, xt))
    with pytest.raises(ValueError, match="sos of shape"):
        SF.sosfilt(st[:, :5], xt)
    with pytest.raises(ValueError, match="cuda or cpu"):
        SF.sosfilt(st, xt.to("meta"))
