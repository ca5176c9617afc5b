"""PyTorch port: OLS solve and the host helpers against the JAX package.

``ols_solve`` must agree within 1e-5 (float32), back-azimuths near 0/360
included (compared on the circle).  The host helpers the port keeps its own
copies of (plan, geometry, time, lstsq, chi-square ellipses) must give the
same values.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from narrow_band_least_squares_tpu.ops import solve as JS
from narrow_band_least_squares_tpu.utils import geometry as JG
from narrow_band_least_squares_tpu.utils import plan as JP
from narrow_band_least_squares_tpu.utils import timeutils as JT
from narrow_band_least_squares_tpu_torch.ops import solve as TS
from narrow_band_least_squares_tpu_torch.utils import geometry as TG
from narrow_band_least_squares_tpu_torch.utils import plan as TP
from narrow_band_least_squares_tpu_torch.utils import timeutils as TT


def _geometry(n=6, seed=0):
    rng = np.random.default_rng(seed)
    rij = rng.uniform(-1.0, 1.0, (2, n))
    X, pairs = JG.coarray(rij)
    return X, pairs


def _tau_for(X, baz_deg, vel, noise, rng, shape=(3, 5)):
    az = np.radians(baz_deg)
    s = -np.stack([np.sin(az), np.cos(az)], -1) / vel          # (..., 2)
    tau = s @ X.T
    return (tau + noise * rng.standard_normal(shape + (X.shape[0],))).astype(np.float32)


def _solve_both(X, tau):
    lsq = JS.precompute_lstsq(X)
    want = JS.ols_solve(jnp.asarray(tau), jnp.asarray(X, jnp.float32),
                        jnp.asarray(lsq["pinv"], jnp.float32),
                        jnp.asarray(lsq["XtX_inv"], jnp.float32))
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32))
    got = TS.ols_solve(t(tau), t(X), t(lsq["pinv"]), t(lsq["XtX_inv"]))
    return got, want


@pytest.mark.parametrize("baz", [230.0, 0.004, 359.996, 90.0])
def test_ols_matches_jax(baz):
    X, _ = _geometry()
    rng = np.random.default_rng(int(baz))
    baz_in = baz + rng.uniform(-0.01, 0.01, (3, 5))
    tau = _tau_for(X, baz_in, 0.34, 1e-3, rng)
    got, want = _solve_both(X, tau)
    for k in ("vel", "sig_tau", "vel_uncert", "baz_uncert", "s", "resid"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-5, atol=1e-5, err_msg=k)
    b = got["baz"].numpy()
    assert ((b >= 0) & (b < 360)).all()
    d = (b - np.asarray(want["baz"]) + 180.0) % 360.0 - 180.0
    np.testing.assert_allclose(d, 0.0, atol=1e-4)


def test_zero_slowness_gives_nan_velocity():
    X, _ = _geometry()
    tau = np.zeros((2, X.shape[0]), np.float32)
    got, want = _solve_both(X, tau)
    assert np.isnan(got["vel"].numpy()).all()
    assert np.isnan(np.asarray(want["vel"])).all()
    np.testing.assert_array_equal(got["baz"].numpy(), np.asarray(want["baz"]))


def test_vel_baz_remainder_not_fmod():
    s = torch.tensor([[1.0, 0.0], [-1.0, 0.0], [0.5, 1e-8]])
    vel, baz = TS.vel_baz_from_slowness(s)
    jv, jb = JS.vel_baz_from_slowness(jnp.asarray(s.numpy()))
    np.testing.assert_allclose(baz.numpy(), np.asarray(jb), atol=1e-4)
    assert (baz >= 0).all()


def test_host_solve_helpers_equal_jax():
    X, _ = _geometry(seed=3)
    a, b = JS.precompute_lstsq(X), TS.precompute_lstsq(X)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    rng = np.random.default_rng(1)
    vel = rng.uniform(0.2, 0.5, 20)
    baz = rng.uniform(0, 360, 20)
    sig = rng.uniform(0, 0.05, 20)
    for x, y in zip(JS.chi2_ellipse_uncertainties(vel, baz, sig, a["XtX_inv"], 0.9),
                    TS.chi2_ellipse_uncertainties(vel, baz, sig, b["XtX_inv"], 0.9)):
        np.testing.assert_array_equal(x, y)


def test_geometry_helpers_equal_jax():
    lat = [64.87, 64.88, 64.86, 64.875]
    lon = [-147.86, -147.85, -147.87, -147.84]
    np.testing.assert_array_equal(JG.get_rij(lat, lon, 4), TG.get_rij(lat, lon, 4))
    np.testing.assert_array_equal(JG.pair_indices(5), TG.pair_indices(5))
    X, pairs = _geometry(seed=2)
    X2, pairs2 = TG.coarray(np.random.default_rng(2).uniform(-1.0, 1.0, (2, 6)))
    np.testing.assert_array_equal(X, X2)
    np.testing.assert_array_equal(pairs, pairs2)
    assert JG.vincenty_inverse(64.8, -147.8, 64.9, -147.7) == \
        TG.vincenty_inverse(64.8, -147.8, 64.9, -147.7)


@pytest.mark.parametrize("kind", ["log", "linear", "octave", "2_octave_over"])
def test_plan_helpers_equal_jax(kind):
    a = JP.get_freqlist(0.1, 5.0, kind, 8)
    b = TP.get_freqlist(0.1, 5.0, kind, 8)
    np.testing.assert_array_equal(a[0], b[0])
    assert a[1:] == b[1:]
    nb = a[1]
    wl = JP.get_winlenlist("adaptive", nb, 50, 60, 30)
    assert list(wl) == list(TP.get_winlenlist("adaptive", nb, 50, 60, 30))
    for band in range(nb):
        assert JP.band_edges(a[0], band, kind) == TP.band_edges(b[0], band, kind)
    pa = JP.make_plan(a[0], kind, wl, 0.5, 6000, 20.0)
    pb = TP.make_plan(b[0], kind, wl, 0.5, 6000, 20.0)
    assert (pa.width, pa.vector_len, pa.num_compute_list) == \
        (pb.width, pb.vector_len, pb.num_compute_list)
    assert [w.starts for w in pa.windows] == [w.starts for w in pb.windows]


def test_time_helpers_equal_jax():
    t = JT.parse_utc("2018-12-19T01:45:00")
    assert t == TT.parse_utc("2018-12-19T01:45:00")
    x = np.array([t, t + 30.5])
    np.testing.assert_array_equal(JT.epoch_to_datenum(x), TT.epoch_to_datenum(x))
    d = float(JT.epoch_to_datenum(np.array([t]))[0])
    assert JT.stdict_timestamp_key(d) == TT.stdict_timestamp_key(d)
