"""PyTorch port: LTS (``alpha < 1``) through the pipelines and the parity
API, against the JAX package on the CPU.

The same stream goes through the JAX package and the port (kernels' plain
versions).  Flags are exact, in two ways (`_check`):

- given the same delays, the port's sweep flags exactly what JAX's
  ``lts_solve``, jitted alone, does, on every window, with the FAST-LTS
  funnel too: the port's `lts_solve` runs on the delays recorded inside the
  JAX step and computes the jitted solve's float32 bits (its multiply-adds
  contracted where XLA contracts them, `ops.kernels.lts_sweep`);
- the two whole runs flag the same pairs on every valid window whose P
  delays are bit-identical between them, and those windows are nearly all
  (`MIN_SAME`).  Elsewhere an integer lag moved: the jitted JAX
  correlation and the port's sum in other orders, and on incoherent pairs
  (the outlier element) the correlation peak can be a near-tie.  In the
  one-band programs (``ltsva``, ``narrow_band_loop``, the broadband
  pipeline) XLA fuses the delays' ``lag * (1/fs)`` into the sweep's
  residuals and contracts it there; the port's one-band pipelines pass the
  lags to `lts_solve` at the sites ``ops.lts.delay_contracted`` lists, and
  on the JAX program's own delays compute its objective, s and retained
  sets bit for bit (`test_one_band_solve_bitwise_jax_program`).

vel/baz/sig_tau and the ``conf=`` intervals agree within 1e-4 (rtol and
atol), the JAX pipeline tolerance, on the windows whose delays and flags
agree, and on every valid window the port's estimates are the float64 fit
of its own retained pairs within 1e-4 (`_refit_close`); within the port,
chunked candidates equal the unchunked sweep bit for bit.  The mirrored JAX
tests are named in each docstring.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from narrow_band_least_squares_tpu import api as japi
from narrow_band_least_squares_tpu.io.synthetic import synthetic_plane_wave
from narrow_band_least_squares_tpu.models.broadband import BroadbandPipeline as JBroad
from narrow_band_least_squares_tpu.models.multiarray import MultiArrayPipeline as JMulti
from narrow_band_least_squares_tpu.models.narrowband import NarrowBandPipeline as JPipe
from narrow_band_least_squares_tpu.ops import lts as JL
from narrow_band_least_squares_tpu.oracle.ltsva import filter_and_taper, sliding_window_solve
from narrow_band_least_squares_tpu.utils.geometry import get_rij
from narrow_band_least_squares_tpu.utils.plan import get_freqlist, get_winlenlist, make_plan
from narrow_band_least_squares_tpu_torch import api as tapi
from narrow_band_least_squares_tpu_torch.models import (
    BroadbandPipeline,
    MultiArrayPipeline,
    NarrowBandPipeline,
)
from narrow_band_least_squares_tpu_torch.ops import lts as TL
from narrow_band_least_squares_tpu_torch.ops.xcorr import lag_seconds
from narrow_band_least_squares_tpu_torch.ops.solve import chi2_ellipse_uncertainties
from narrow_band_least_squares_tpu_torch.state import state_from_numpy
from narrow_band_least_squares_tpu_torch.utils import plan as tplan
from narrow_band_least_squares_tpu_torch.utils.geometry import coarray

from test_torch_multiarray import arrays  # noqa: F401  (fixture)
from test_torch_pipeline import OUTS, _jax_state, _tstream

_JAX_LTS_SOLVE, _TORCH_LTS_SOLVE = JL.lts_solve, TL.lts_solve
TOL = 1e-4
MIN_SAME = 0.9   # share of valid windows whose delays must be bit-identical


def _np(v):
    return v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _close(got, want, keys=("vel", "baz", "sig_tau", "mdccm"), tol=TOL, where=None):
    for k in keys:
        g, w = _np(got[k]), _np(want[k])
        if where is not None:
            g, w = g[where], w[where]
        np.testing.assert_allclose(g, w, rtol=tol, atol=tol, err_msg=k)


@pytest.fixture
def delays(monkeypatch):
    """Records the delays every LTS solve receives, with the array's
    co-array: the port's as they come, JAX's from inside its jitted step (a
    debug callback; under the multi-array vmap the calls come in no fixed
    order).  Pipelines must be built and first run inside the test; the
    API's caches are cleared."""
    rec = {"jax": [], "torch": []}

    def jspy(tau, X, *a, **k):
        jax.debug.callback(lambda t, x: rec["jax"].append((np.asarray(x), np.asarray(t))),
                           tau, X)
        return _JAX_LTS_SOLVE(tau, X, *a, **k)

    def tspy(tau, X, *a, **k):
        rec["torch"].append((X.numpy().copy(), tau.numpy().copy()))
        return _TORCH_LTS_SOLVE(tau, X, *a, **k)

    monkeypatch.setattr(JL, "lts_solve", jspy)
    monkeypatch.setattr(TL, "lts_solve", tspy)
    japi._cached_pipeline.cache_clear()
    tapi._cached_pipeline.cache_clear()
    yield rec
    japi._cached_pipeline.cache_clear()
    tapi._cached_pipeline.cache_clear()


def _taus(delays, pipe, run=0, geometry=None):
    """(port, JAX) delays: the port's ``run``-th solve with this co-array
    (the merged batch solves its arrays in order), and of JAX's solves with
    this co-array the one with the most valid windows equal to it (arrays
    may share a geometry, and JAX's callbacks come in no fixed order).

    JAX's debug callbacks are unordered effects: ``jax.effects_barrier()``
    waits for every one in flight before the record is read.  A record with
    no solve of this co-array, or none whose delays match the port's on
    MIN_SAME of the valid windows, fails with what was recorded."""
    jax.effects_barrier()
    X = (geometry or pipe._geometry)["X"].numpy()
    tau_t = [t for x, t in delays["torch"] if np.array_equal(x, X)][run]
    cands = [t for x, t in delays["jax"] if np.array_equal(x, X)]
    shapes = sorted({x.shape for x, _ in delays["jax"]})
    assert cands, (f"none of the {len(delays['jax'])} recorded JAX solves (co-array "
                   f"shapes {shapes}) has the port's co-array {X.shape}")
    wm = pipe.state_dict()["win_mask"].numpy()
    shares = [float(((t == tau_t).all(-1) & wm).sum() / wm.sum()) for t in cands]
    best = int(np.argmax(shares))
    assert shares[best] >= MIN_SAME, (
        f"port solve {run}: no recorded JAX solve with its co-array has equal delays on "
        f"{MIN_SAME:.0%} of the valid windows; shares {[round(v, 3) for v in shares]} "
        f"over {len(cands)} of {len(delays['jax'])} JAX solves")
    return tau_t, cands[best]


@functools.lru_cache(maxsize=None)
def _jax_retained(h, c_steps, candidate_chunk, funnel_k):
    """The JAX package's `lts_solve`, jitted on its own, -> retained."""
    return jax.jit(lambda *a: _JAX_LTS_SOLVE(
        *a, h, c_steps, candidate_chunk=candidate_chunk, funnel_k=funnel_k)["retained"])


def _sweeps(pipe, tau, geometry=None):
    """Flags (B, Wmax, P) of the port's `lts_solve` and of the JAX
    package's on ``tau`` with ``pipe``'s constants and options."""
    g = geometry or pipe._geometry
    args = tuple(g[k] for k in ("X", "cand", "Ainv", "cand_ok"))
    opts = (pipe.h, pipe.c_steps, pipe.lts_candidate_chunk, pipe.lts_funnel_k)
    port = _TORCH_LTS_SOLVE(torch.as_tensor(tau.copy()), *args, opts[0], opts[1],
                            candidate_chunk=opts[2], funnel_k=opts[3])["retained"]
    ref = _jax_retained(*opts)(jnp.asarray(tau), *(jnp.asarray(a.numpy()) for a in args))
    wm = pipe.state_dict()["win_mask"].numpy()[..., None]
    return ~port.numpy() & wm, ~np.asarray(ref) & wm


def _trimmed(tau, X, keep, h):
    """float64 LTS criterion of a retained set: its least-squares fit's h
    smallest squared residuals."""
    s = np.linalg.lstsq(X[keep], tau[keep].astype(np.float64), rcond=None)[0]
    return np.sort((tau - X @ s) ** 2)[:h].sum()


def _compare_flags(pipe, gf, wf, tau_t, tau_j, geometry=None):
    """Flags (B, Wmax, P) of the port run ``gf`` and the JAX run ``wf``:
    the two checks of the module docstring.  On the same delays the sweeps
    agree exactly, funnel or not; the whole runs flag the same pairs on
    every valid window whose delays are bit-identical.  Returns those
    windows."""
    wm = pipe.state_dict()["win_mask"].numpy()
    ours, theirs = _sweeps(pipe, tau_j, geometry)
    np.testing.assert_array_equal(ours, theirs)
    same = (tau_t == tau_j).all(-1) & wm
    share = same.sum() / wm.sum()
    assert share >= MIN_SAME, f"only {share:.3f} of the valid windows have equal delays"
    np.testing.assert_array_equal(gf[same], wf[same])
    return same


def _refit_close(pipe, got, tau, X):
    """On every valid window, the port's vel/baz/sig_tau equal the float64
    least-squares fit of its own retained pairs within TOL: a check that
    holds where its flags differ from JAX's too."""
    flags = _np(got["flags"])
    dof = max(pipe.h - 2, 1)
    for b, w in np.argwhere(pipe.state_dict()["win_mask"].numpy()):
        keep = ~flags[b, w]
        t = tau[b, w].astype(np.float64)
        s = np.linalg.lstsq(X[keep], t[keep], rcond=None)[0]
        r = t[keep] - X[keep] @ s
        want = {"vel": 1.0 / np.hypot(*s),
                "baz": np.degrees(np.arctan2(-s[0], -s[1])) % 360.0,
                "sig_tau": np.sqrt(r @ r / dof)}
        for k, v in want.items():
            g = float(_np(got[k])[b, w])
            d = abs((g - v + 180.0) % 360.0 - 180.0) if k == "baz" else abs(g - v)
            assert d <= TOL + TOL * abs(v), f"{k} window {(b, w)}: {g} against {v}"


def _check(pipe, got, want, delays, run=0, geometry=None,
           keys=("vel", "baz", "sig_tau")):
    """Port run ``got`` against JAX run ``want`` (dicts of (B, Wmax[, P])
    outputs) of one array (`_compare_flags`); ``keys`` within TOL on the
    windows whose delays and flags agree, and the port's estimates those of
    its own flags on every window (`_refit_close`)."""
    tau_t, tau_j = _taus(delays, pipe, run, geometry)
    same = _compare_flags(pipe, _np(got["flags"]), _np(want["flags"]), tau_t, tau_j,
                          geometry)
    _close(got, want, keys, where=same)
    X = (geometry or pipe._geometry)["X"].numpy().astype(np.float64)
    _refit_close(pipe, got, tau_t, X)


def _dense(pipe, stdict):
    """An API stdict (keys in band, window order) -> flags (B, Wmax, P)."""
    P = len(pipe.pairs_np)
    index = {(int(i) + 1, int(j) + 1): p for p, (i, j) in enumerate(pipe.pairs_np)}
    flags = np.zeros((pipe.plan.nbands, pipe.plan.max_windows, P), dtype=bool)
    keys = iter(k for k in stdict if k != "size")
    for b, nw in enumerate(pipe.plan.num_compute_list):
        for w in range(nw):
            key = next(keys)
            for pair in np.asarray(stdict[key]).reshape(-1, 2):
                flags[b, w, index[tuple(int(e) for e in pair)]] = True
    return flags


def _check_stdict(pipe, got, want, delays):
    """`_compare_flags` on two API stdicts of ``pipe``'s plan; returns the
    (band, window) mask of the windows whose delays and flags agree."""
    assert got.keys() == want.keys() and got["size"] == want["size"]
    tau_t, tau_j = _taus(delays, pipe)
    return _compare_flags(pipe, _dense(pipe, got), _dense(pipe, want), tau_t, tau_j)


def _plans(st, nbands=2, kind="constant"):
    fl, nb, _ = get_freqlist(0.3, 1.2, "log", nbands)
    wl = (get_winlenlist("constant", nb, 30, 0, 0) if kind == "constant"
          else get_winlenlist("adaptive", nb, 30, 40, 20))
    args = (fl, "log", wl, 0.5, st.npts, st.fs)
    return make_plan(*args), tplan.make_plan(*args)


@pytest.fixture(scope="module")
def filtered(outlier_stream):
    """The outlier stream band-passed by the oracle, for ``ltsva``."""
    st = outlier_stream
    stf = st.copy()
    stf.data, _ = filter_and_taper(st.data, st.fs, "cheby1", 0.2, 1.2, 2, 0.01)
    return stf


# --------------------------------------------------------------------------
# ltsva (tests/test_jax_pipeline.py:97 and :147, tests/test_oracle.py:44)
# --------------------------------------------------------------------------

def _ltsva_pipe(st, rij, winlen=30.0):
    """The port pipeline the API's ``ltsva`` built (and cached)."""
    plan = tplan.make_plan([0.0, st.fs / 2], "linear", [winlen], 0.5, st.npts, st.fs)
    return tapi._get_pipeline(plan, rij, alpha=0.75, apply_filter=False, device="cpu")


def test_lts_chi2_ci_uses_retained_subset_geometry(filtered, delays):
    """Mirror of ``test_jax_pipeline.py:97``: with ALPHA < 1 the chi2
    intervals come from each window's retained co-array rows; they equal
    JAX's within 1e-4 where the delays agree and are never narrower than
    the full-geometry ones."""
    st = filtered
    rij = get_rij(st.latitudes, st.longitudes, st.nchans)
    args = (st.latitudes, st.longitudes, 30.0, 0.5, 0.75)
    want = japi.ltsva(st, *args, conf=0.90)
    got = tapi.ltsva(_tstream(st), *args, conf=0.90, device="cpu")
    n = len(got[0])
    same = _check_stdict(_ltsva_pipe(st, rij), got[4], want[4], delays)[0, :n]
    for i in (0, 1, 3, 5, 6, 7):
        np.testing.assert_allclose(got[i][same], want[i][same], rtol=TOL, atol=TOL,
                                   err_msg=str(i))
    np.testing.assert_array_equal(got[2], want[2])
    vel, baz, _, _, _, sig_tau, vu, bu = got
    X, _ = coarray(rij)
    vu_full, bu_full = chi2_ellipse_uncertainties(vel, baz, sig_tau,
                                                  np.linalg.inv(X.T @ X), conf=0.90)
    assert np.all(vu >= vu_full - 1e-12) and np.all(bu >= bu_full - 1e-12)
    assert np.any(vu > vu_full * 1.0001)


def test_lts_flags_match_jax_and_oracle(filtered, delays):
    """Mirror of ``test_jax_pipeline.py:147``: the stdict equals JAX's
    (`_check_stdict`), and agrees with the float64 oracle as the JAX one
    does."""
    st = filtered
    rij = get_rij(st.latitudes, st.longitudes, st.nchans)
    o = sliding_window_solve(st.data, rij, st.fs, st.start_epoch, 30.0, 0.5, 0.75)
    args = (st.latitudes, st.longitudes, 30.0, 0.5, 0.75)
    want = japi.ltsva(st, *args)
    vel, baz, t, mdccm, stdict, sig, _, _ = tapi.ltsva(_tstream(st), *args, device="cpu")
    _check_stdict(_ltsva_pipe(st, rij), stdict, want[4], delays)
    o_keys = set(k for k in o["stdict"] if k != "size")
    assert o_keys == set(k for k in stdict if k != "size")
    agree = total = 0
    for key in sorted(o_keys):
        fo = set(map(tuple, np.asarray(o["stdict"][key]).reshape(-1, 2)))
        fg = set(map(tuple, np.asarray(stdict[key]).reshape(-1, 2)))
        agree += len(fo & fg)
        total += max(len(fo), len(fg), 1)
    assert agree / total > 0.75
    d_baz = np.abs((baz - o["baz"] + 180.0) % 360.0 - 180.0)
    assert np.quantile(d_baz, 0.75) < 2.0


def test_lts_flags_outlier_element(filtered):
    """Mirror of ``test_oracle.py:44`` on the port: the incoherent element's
    pairs dominate the flags, the direction is recovered, and the stdict
    has the reference's format."""
    st = filtered
    vel, baz, t, mdccm, stdict, _, _, _ = tapi.ltsva(
        _tstream(st), st.latitudes, st.longitudes, 30.0, 0.5, 0.75, device="cpu")
    keys = [k for k in stdict if k != "size"]
    assert len(keys) == len(vel) and stdict["size"] == st.nchans
    counts = np.zeros(st.nchans + 1)
    for k in keys:
        assert len(k.split(".")[-1]) == 7
        v = np.asarray(stdict[k])
        if len(v):
            assert v.min() >= 1 and v.max() <= st.nchans
        np.add.at(counts, v, 1)
    assert counts.argmax() == 3                       # element 2, 1-based
    good = mdccm > 0.5
    assert abs(np.median(baz[good]) - 120.0) < 8.0


# --------------------------------------------------------------------------
# the pipeline (tests/test_jax_pipeline.py:247 and :279)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [{}, {"lts_candidate_chunk": 17}, {"lts_funnel_k": 16},
                                {"xcorr_method": "fused", "lts_funnel_k": 16}],
                         ids=["exhaustive", "chunk17", "funnel16", "fused-funnel16"])
def test_run_raw_matches_jax(outlier_stream, delays, kw):
    st = outlier_stream
    jp, tp = _plans(st, 3, "adaptive")
    rij = get_rij(st.latitudes, st.longitudes, st.nchans)
    jkw = dict(kw, matmul_precision="highest") if "xcorr_method" in kw else kw
    want = JPipe(jp, rij, alpha=0.75, **jkw).run_raw(st.data)
    pipe = NarrowBandPipeline(tp, rij, alpha=0.75, device="cpu", **kw)
    got = pipe.run_raw(st.data)
    assert got["flags"].shape == (tp.nbands, tp.max_windows, 15)
    _check(pipe, got, want, delays, keys=OUTS)


def test_chunked_candidates_identical(outlier_stream):
    """Mirror of ``test_jax_pipeline.py:247`` through the pipeline: chunked
    candidates equal the one-block sweep bit for bit."""
    st = outlier_stream
    _, tp = _plans(st)
    rij = get_rij(st.latitudes, st.longitudes, st.nchans)
    full = NarrowBandPipeline(tp, rij, alpha=0.75, device="cpu").run_raw(st.data)
    chunked = NarrowBandPipeline(tp, rij, alpha=0.75, lts_candidate_chunk=17,
                                 device="cpu").run_raw(st.data)
    for k, v in full.items():
        torch.testing.assert_close(chunked[k], v, rtol=0, atol=0, equal_nan=True, msg=k)


def test_lts_funnel_matches_full_sweep(delays):
    """Mirror of ``test_jax_pipeline.py:279``: each schedule's flags equal
    JAX's (`_check`), and the funnel reproduces the full sweep's on >= 99%
    of the decisions, with equal estimates where the flags agree."""
    st = synthetic_plane_wave(
        nchans=6, duration_s=300.0, fs=10.0, baz_deg=140.0,
        trace_vel_kms=0.33, f0=0.6, bandwidth=0.8, snr=8.0, seed=9,
        outlier_channels=(1,),
    )
    jp, tp = _plans(st, 3, "adaptive")
    rij = get_rij(st.latitudes, st.longitudes, st.nchans)
    runs = {}
    for i, k in enumerate((0, 16)):
        want = JPipe(jp, rij, alpha=0.75, lts_funnel_k=k).run_raw(st.data)
        pipe = NarrowBandPipeline(tp, rij, alpha=0.75, lts_funnel_k=k, device="cpu")
        runs[k] = pipe.run_raw(st.data)
        _check(pipe, runs[k], want, delays, run=i)
    f0, f1 = runs[0]["flags"].numpy(), runs[16]["flags"].numpy()
    assert np.mean(f0 == f1) > 0.99
    same = (f0 == f1).all(axis=-1)
    np.testing.assert_allclose(runs[0]["vel"].numpy()[same], runs[16]["vel"].numpy()[same],
                               rtol=1e-5, atol=1e-6)


def test_capped_candidates_match_jax(delays):
    """The capped candidate set on which the port once kept a worse subset
    than JAX (ROADMAP.md Queue 3, fixed: window (band 1, window 4), where
    the port's float32 residuals tied at the h boundary and JAX's, with
    XLA's fused multiply-adds, did not).  Through `_check`, the sweeps equal
    JAX's jitted ``lts_solve`` exactly; the whole runs flag the same pairs
    on every valid window with equal delays; and on JAX's delays the port's
    objective and s are the jitted solve's float32 bits."""
    st = synthetic_plane_wave(
        nchans=6, duration_s=300.0, fs=10.0, baz_deg=200.0, trace_vel_kms=0.33,
        f0=0.6, bandwidth=0.8, snr=10.0, seed=3, outlier_channels=(2,),
    )
    fl, nb, _ = get_freqlist(0.2, 1.6, "log", 4)
    args = (fl, "log", get_winlenlist("adaptive", nb, 30, 40, 20), 0.5, st.npts, st.fs)
    rij = get_rij(st.latitudes, st.longitudes, st.nchans)
    want = JPipe(make_plan(*args), rij, alpha=0.75, max_lts_candidates=5).run_raw(st.data)
    pipe = NarrowBandPipeline(tplan.make_plan(*args), rij, alpha=0.75, max_lts_candidates=5,
                              device="cpu")
    got = pipe.run_raw(st.data)
    _check(pipe, got, want, delays, keys=OUTS)
    tau_t, tau_j = _taus(delays, pipe)
    same = (tau_t == tau_j).all(-1) & pipe.state_dict()["win_mask"].numpy()
    assert same[1, 4]
    np.testing.assert_array_equal(_np(got["flags"])[same], _np(want["flags"])[same])
    g = pipe._geometry
    consts = tuple(g[k] for k in ("X", "cand", "Ainv", "cand_ok"))
    port = _TORCH_LTS_SOLVE(torch.as_tensor(tau_j.copy()), *consts, pipe.h, pipe.c_steps)
    ref = jax.jit(lambda t, *a: _JAX_LTS_SOLVE(t, *a, pipe.h, pipe.c_steps))(
        tau_j, *(c.numpy() for c in consts))
    for k in ("objective", "s"):
        np.testing.assert_array_equal(port[k].numpy().view(np.int32),
                                      np.asarray(ref[k]).view(np.int32), err_msg=k)
    X = g["X"].numpy().astype(np.float64)
    crit = _trimmed(tau_j[1, 4], X, port["retained"].numpy()[1, 4], pipe.h)
    assert abs(crit - 2.06056) < 1e-4, crit


def test_state_round_trip_with_jax_constants(outlier_stream):
    """The LTS constants join the state under the JAX names: ``cand``
    (int32), ``Ainv`` (float32), ``cand_ok`` (bool); loading the JAX
    pipeline's constants reproduces the port's run bit for bit."""
    st = outlier_stream
    jp, tp = _plans(st)
    rij = get_rij(st.latitudes, st.longitudes, st.nchans)
    jstate = _jax_state(JPipe(jp, rij, alpha=0.75))
    tpipe = NarrowBandPipeline(tp, rij, alpha=0.75, device="cpu")
    own = tpipe.state_dict()
    assert set(own) == set(jstate)
    assert own["cand"].dtype == torch.int32 and own["cand_ok"].dtype == torch.bool
    assert own["Ainv"].dtype == torch.float32 and own["cand"].shape == (105, 2)
    for k, v in jstate.items():
        np.testing.assert_allclose(own[k].numpy().astype(np.float64), v.astype(np.float64),
                                   rtol=0, atol=1e-7, err_msg=k)
    before = tpipe.run_raw(st.data)
    loaded = NarrowBandPipeline(tp, rij, alpha=0.75, device="cpu")
    loaded.load_state(state_from_numpy(jstate))
    after = loaded.run_raw(st.data)
    for k, v in before.items():
        torch.testing.assert_close(after[k], v, rtol=0, atol=0, equal_nan=True, msg=k)


# --------------------------------------------------------------------------
# large arrays (tests/test_large_array.py; the JAX-parity runs are in
# tests/test_torch_lts_large.py)
# --------------------------------------------------------------------------

BAZ, VEL = 285.0, 0.33


def _large(nchans, outliers, duration_s=160.0):
    st = synthetic_plane_wave(
        nchans=nchans, duration_s=duration_s, fs=10.0, baz_deg=BAZ,
        trace_vel_kms=VEL, f0=0.6, bandwidth=0.8, snr=12.0,
        aperture_km=3.0, seed=5, outlier_channels=outliers,
    )
    jp, tp = _plans(st)
    return st, jp, tp, get_rij(st.latitudes, st.longitudes, st.nchans)


def test_large_array_candidate_policy():
    """Mirror of ``test_large_array.py:89,147``: full enumeration is the
    default with the chunk set to 4096 past 4096 candidates, 'auto'
    resolves the funnel to max(16, ceil(Q/24)), and to 0 with OLS."""
    _, _, tp, rij = _large(16, ())
    pipe = NarrowBandPipeline(tp, rij, alpha=0.75, lts_funnel_k="auto", device="cpu")
    assert pipe.state_dict()["cand"].shape == (7140, 2)
    assert pipe.lts_candidate_chunk == 4096 and pipe.lts_funnel_k == 298
    assert NarrowBandPipeline(tp, rij, alpha=0.75, max_lts_candidates=2048,
                              device="cpu").state_dict()["cand"].shape == (2048, 2)
    _, _, tp12, rij12 = _large(12, ())
    p12 = NarrowBandPipeline(tp12, rij12, alpha=0.75, lts_funnel_k="auto", device="cpu")
    assert p12.lts_candidate_chunk == 0 and p12.lts_funnel_k == max(16, -(-2145 // 24))
    ols = NarrowBandPipeline(tp12, rij12, lts_funnel_k="auto", device="cpu")
    assert ols.lts_funnel_k == 0 and "cand" not in ols.state_dict()


# --------------------------------------------------------------------------
# multi-array and broadband (tests/test_multiarray.py:108-191)
# --------------------------------------------------------------------------

MULTI = [
    ("maxlag", dict(max_lag_s=8.0)),
    ("funnel", dict(max_lag_s=8.0, lts_funnel_k=4)),
    ("gather-nobucket", dict(window_method="gather", bucket_bands=False, lts_funnel_k=4)),
    ("production-auto", dict(lts_funnel_k="auto", band_limit_db="auto")),
    ("fused", dict(xcorr_method="fused")),
    ("fused-funnel", dict(xcorr_method="fused", lts_funnel_k=4)),
]


@pytest.mark.parametrize("kw", [m[1] for m in MULTI], ids=[m[0] for m in MULTI])
def test_multiarray_lts_matches_jax_and_individual(arrays, delays, kw):  # noqa: F811
    """Mirror of ``test_multiarray.py:108,139``: each array of the merged
    batch against the JAX batch (`_check`, with the array's own constants),
    and its flags bit for bit those of its single-array run, funnel
    included."""
    data, jp, tp, rijs = arrays
    jkw = dict(kw, matmul_precision="highest") if "xcorr_method" in kw else kw
    want = JMulti(jp, rijs, alpha=0.75, **jkw).run_raw(data)
    multi = MultiArrayPipeline(tp, rijs, alpha=0.75, device="cpu", **kw)
    got = multi.run_raw(data)
    assert got["flags"].shape == (4, tp.nbands, tp.max_windows, 6)
    for k, rij in enumerate(rijs):
        _check(multi.base, {n: v[k] for n, v in got.items()},
               {n: v[k] for n, v in want.items()}, delays, run=k,
               geometry=multi._geometry[k])
        one = NarrowBandPipeline(tp, rij, alpha=0.75, device="cpu", **kw).run_raw(data[k])
        np.testing.assert_array_equal(got["flags"][k].numpy(), one["flags"].numpy())
        _close({n: v[k] for n, v in got.items()}, one, tol=1e-5)


def test_multiarray_max_lts_candidates_respected(arrays):  # noqa: F811
    """Mirror of ``test_multiarray.py:180``."""
    _, _, tp, rijs = arrays
    batch = MultiArrayPipeline(tp, rijs, alpha=0.75, max_lts_candidates=10, device="cpu")
    assert all(g["cand"].shape == (10, 2) for g in batch._geometry)
    assert batch.base.state_dict()["cand"].shape == (10, 2)
    full = MultiArrayPipeline(tp, rijs, alpha=0.75, device="cpu")
    assert all(g["cand"].shape == (15, 2) for g in full._geometry)


def test_broadband_lts_matches_jax(outlier_stream, delays):
    st = outlier_stream
    rij = get_rij(st.latitudes, st.longitudes, st.nchans)
    args = (0.3, 1.2, 30.0, 0.5, st.npts, st.fs, rij)
    want = JBroad(*args, alpha=0.75).run_raw(st.data)
    pipe = BroadbandPipeline(*args, alpha=0.75, device="cpu")
    got = pipe.run_raw(st.data)
    _check(pipe, got, want, delays, keys=OUTS)


# --------------------------------------------------------------------------
# the narrow-band API
# --------------------------------------------------------------------------

def test_api_lts_matches_jax(outlier_stream, delays):
    st = outlier_stream
    fl, nb, _ = get_freqlist(0.3, 1.2, "log", 3)
    wl = get_winlenlist("adaptive", nb, 30, 40, 20)
    fr = np.logspace(-2, np.log10(st.fs / 2), 20)
    args = (wl, 0.5, 0.75)
    tail = (st.latitudes, st.longitudes, nb, None, None, fl, "log", fr, "cheby1", 2, 0.01)
    want = japi.narrow_band_least_squares(*args, st, *tail)
    got = tapi.narrow_band_least_squares(*args, _tstream(st), *tail, device="cpu")
    plan = tplan.make_plan(fl, "log", wl, 0.5, st.npts, st.fs)
    pipe = tapi._get_pipeline(plan, get_rij(st.latitudes, st.longitudes, st.nchans),
                              alpha=0.75, device="cpu")
    same = _check_stdict(pipe, got[4], want[4], delays)
    assert all(k[:3] in ("01_", "02_", "03_") for k in got[4] if k != "size")
    W = same.shape[1]
    for i in (0, 1, 2, 5):
        np.testing.assert_allclose(got[i][:, :W][same], want[i][:, :W][same],
                                   rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(got[3], want[3])
    assert got[6] == want[6]


def test_narrow_band_loop_lts_matches_jax(outlier_stream, delays):
    """The band's stdict, flattened into the two object arrays of the
    reference's worker contract, equals JAX's where the delays agree."""
    st = outlier_stream
    fl, nb, _ = get_freqlist(0.3, 1.2, "log", 2)
    fr = np.logspace(-2, np.log10(st.fs / 2), 20)
    args = (1, fl, "log", fr)
    tail = ("cheby1", 2, 0.01, st.latitudes, st.longitudes, [30.0, 20.0], 0.5, 0.75, 30)
    want = japi.narrow_band_loop(*args, st, *tail)
    got = tapi.narrow_band_loop(*args, _tstream(st), *tail, device="cpu")
    n = int(got[7])
    assert n == int(want[7]) and got[4].dtype == object and got[5].dtype == object
    np.testing.assert_array_equal(got[4], want[4])
    assert got[4][-1] == "size" and got[5][-1] == st.nchans
    pipe = _ltsva_pipe(st, get_rij(st.latitudes, st.longitudes, st.nchans), 20.0)
    same = _check_stdict(pipe, dict(zip(got[4], got[5])), dict(zip(want[4], want[5])),
                         delays)[0, :n]
    for i in (0, 1, 2, 6):
        np.testing.assert_allclose(got[i][:n][same], want[i][:n][same], rtol=TOL, atol=TOL)


def test_production_defaults_resolve_the_funnel(outlier_stream):
    st = outlier_stream
    prev = tapi.set_performance_defaults(**tapi.PRODUCTION_DEFAULTS)
    try:
        _, tp = _plans(st)
        rij = get_rij(st.latitudes, st.longitudes, st.nchans)
        pipe = tapi._get_pipeline(tp, rij, alpha=0.75, device="cpu")
        assert pipe.lts_funnel_k == 16 and pipe.band_limit_db == "auto"
        assert tapi._get_pipeline(tp, rij, device="cpu").lts_funnel_k == 0
    finally:
        tapi.set_performance_defaults(
            **{k: None for k in tapi.PRODUCTION_DEFAULTS}, **prev)


# --------------------------------------------------------------------------
# the one-band programs' contracted delays
# --------------------------------------------------------------------------

def _outliers(nchans, duration_s=240.0):
    """The outlier stream's setup (``tests/conftest.py``) at ``nchans``
    elements."""
    return synthetic_plane_wave(
        nchans=nchans, duration_s=duration_s, fs=10.0, baz_deg=120.0, trace_vel_kms=0.30,
        f0=0.6, bandwidth=0.8, snr=15.0, aperture_km=2.5, seed=11, outlier_channels=(2,))


def test_ltsva_eight_elements_matches_jax(delays):
    """``ltsva`` at P = 28, whose one-band program also contracts the delays
    into both halves of the objective's first tree level: the stdict equals
    JAX's on every valid window with equal delays (`_check_stdict`)."""
    st = _outliers(8)
    st.data, _ = filter_and_taper(st.data, st.fs, "cheby1", 0.2, 1.2, 2, 0.01)
    rij = get_rij(st.latitudes, st.longitudes, st.nchans)
    args = (st.latitudes, st.longitudes, 30.0, 0.5, 0.75)
    want = japi.ltsva(st, *args)
    got = tapi.ltsva(_tstream(st), *args, device="cpu")
    pipe = _ltsva_pipe(st, rij)
    assert pipe._delay_sites == TL.delay_contracted(28, "exhaustive")
    assert {"objective.lo", "objective.hi"} <= pipe._delay_sites
    n = len(got[0])
    same = _check_stdict(pipe, got[4], want[4], delays)[0, :n]
    for i in (0, 1, 3, 5):
        np.testing.assert_allclose(got[i][same], want[i][same], rtol=TOL, atol=TOL,
                                   err_msg=str(i))
    np.testing.assert_array_equal(got[2], want[2])


def test_two_band_constant_windows_keep_the_rounded_delays(outlier_stream, delays):
    """Two bands with constant windows (one bucket): the JAX program fuses
    no delay into the sweep, so the port passes none and its flags equal
    JAX's as the multi-band rule has it (`_check`)."""
    st = outlier_stream
    jp, tp = _plans(st, 2, "constant")
    rij = get_rij(st.latitudes, st.longitudes, st.nchans)
    want = JPipe(jp, rij, alpha=0.75).run_raw(st.data)
    pipe = NarrowBandPipeline(tp, rij, alpha=0.75, device="cpu")
    assert len(pipe._buckets) == 1 and pipe._delay_sites == frozenset()
    got = pipe.run_raw(st.data)
    _check(pipe, got, want, delays, keys=OUTS)


@pytest.fixture
def jax_solves(monkeypatch):
    """Records what the JAX package's ``lts_solve`` takes and returns inside
    its compiled step (a debug callback): (tau, objective, s, retained)."""
    rec = []

    def jspy(tau, X, *a, **k):
        out = _JAX_LTS_SOLVE(tau, X, *a, **k)
        jax.debug.callback(lambda *v: rec.append([np.asarray(x) for x in v]),
                           tau, out["objective"], out["s"], out["retained"])
        return out

    monkeypatch.setattr(JL, "lts_solve", jspy)
    yield rec


# (id, elements, options, stream seconds): 240 s is 15 windows of 30 s, 600 s 39
ONE_BAND = [("P15", 6, {}, 240.0), ("P15-funnel16", 6, {"lts_funnel_k": 16}, 240.0),
            ("P28", 8, {}, 240.0), ("P28-funnel16", 8, {"lts_funnel_k": 16}, 240.0),
            ("P28-chunk100", 8, {"lts_candidate_chunk": 100}, 240.0), ("P36", 9, {}, 240.0),
            ("P28-39windows", 8, {}, 600.0)]


@pytest.mark.parametrize("case", ONE_BAND, ids=[c[0] for c in ONE_BAND])
def test_one_band_solve_bitwise_jax_program(jax_solves, case):
    """The port's `lts_solve` with the lags and the pipeline's sites, on the
    delays of the JAX package's one-band program, computes that program's
    objective, s and retained sets bit for bit on every valid window; the
    rounded delays alone (the jitted solve's model) do not, except chunked,
    where the program fuses no delay into the candidates' sweep.  The table
    is keyed by P and schedule: the 39-window case holds it at another
    window count than the 15 it was read at."""
    name, nchans, kw, duration = case
    st = _outliers(nchans, duration)
    rij = get_rij(st.latitudes, st.longitudes, st.nchans)
    args = ([0.3, 1.2], "linear", [30.0], 0.5, st.npts, st.fs)
    JPipe(make_plan(*args), rij, alpha=0.75, **kw).run_raw(st.data)
    jax.effects_barrier()
    tau, obj, s, ret = jax_solves[-1]
    pipe = NarrowBandPipeline(tplan.make_plan(*args), rij, alpha=0.75, device="cpu", **kw)
    g, wm = pipe._geometry, pipe.state_dict()["win_mask"].numpy()
    lag = np.rint(tau.astype(np.float64) * st.fs).astype(np.float32)
    tt, lt = torch.as_tensor(tau.copy()), torch.as_tensor(lag)
    assert torch.equal(lag_seconds(lt, st.fs), tt)

    def solve(sites):
        out = TL.lts_solve(tt, g["X"], g["cand"], g["Ainv"], g["cand_ok"], pipe.h,
                           pipe.c_steps, candidate_chunk=pipe.lts_candidate_chunk,
                           funnel_k=pipe.lts_funnel_k, lag=lt, inv_fs=1.0 / st.fs,
                           delay_sites=sites)
        return (out["objective"].numpy().view(np.int32), out["s"].numpy().view(np.int32),
                out["retained"].numpy())

    want = (obj.view(np.int32), s.view(np.int32), ret)
    for got, w in zip(solve(pipe._delay_sites), want):
        np.testing.assert_array_equal(got[wm], w[wm])
    rounded = solve(frozenset())
    assert ("chunk" in name) == all(
        np.array_equal(a[wm], b[wm]) for a, b in zip(rounded, want))


@pytest.mark.parametrize("merge", [2, 4], ids=["two-chunks", "one-chunk"])
def test_multiarray_one_band_solve_bitwise_jax_program(  # noqa: F811
        arrays, jax_solves, monkeypatch, merge):
    """The merged multi-array program at one band fuses the delays into the
    sweep as the single-array one does when its four arrays form one merge
    chunk; from two chunks it concatenates the delays first and fuses
    nothing (`scripts/xla_contractions.py --ltsva`).  The port passes the
    lags exactly in the first case, and each array's solve on the JAX
    program's delays is that program's objective, s and retained sets bit
    for bit, with that array's constants: each recorded solve is matched to
    its array by the delays it took, one solve an array."""
    data, _, _, rijs = arrays
    args = ([0.3, 1.2], "linear", [30.0], 0.5, data.shape[-1], 10.0)
    JMulti(make_plan(*args), rijs, alpha=0.75, merge_chunk_arrays=merge).run_raw(data)
    jax.effects_barrier()
    multi = MultiArrayPipeline(tplan.make_plan(*args), rijs, alpha=0.75,
                               merge_chunk_arrays=merge, device="cpu")
    base, wm = multi.base, multi.base.state_dict()["win_mask"].numpy()
    passed, taus = [], []

    def tspy(tau, X, *a, **k):
        passed.append(k.get("lag") is not None and bool(k.get("delay_sites")))
        taus.append(tau.numpy().copy())
        return _TORCH_LTS_SOLVE(tau, X, *a, **k)

    monkeypatch.setattr(TL, "lts_solve", tspy)
    multi.run_raw(data)
    fused = merge >= len(rijs)
    assert passed == [fused] * len(rijs)
    sites = TL.delay_contracted(6, "exhaustive") if fused else frozenset()
    assert len(jax_solves) == len(rijs)
    matched = []
    for tau, obj, s, ret in jax_solves:
        # the array of this solve: the one whose delays it shares on most windows
        agree = [int((t == tau).all(-1)[wm].sum()) for t in taus]
        a = int(np.argmax(agree))
        assert sorted(agree)[-2] < agree[a] and agree[a] >= MIN_SAME * wm.sum(), agree
        matched.append(a)
        g = multi._geometry[a]
        lag = torch.as_tensor(np.rint(tau.astype(np.float64) * 10.0).astype(np.float32))
        out = _TORCH_LTS_SOLVE(torch.as_tensor(tau.copy()), g["X"], g["cand"], g["Ainv"],
                               g["cand_ok"], base.h, base.c_steps, lag=lag, inv_fs=0.1,
                               delay_sites=sites)
        for got, w in ((out["objective"].numpy().view(np.int32), obj.view(np.int32)),
                       (out["s"].numpy().view(np.int32), s.view(np.int32)),
                       (out["retained"].numpy(), ret)):
            np.testing.assert_array_equal(got[wm], w[wm], err_msg=f"array {a}")
    assert sorted(matched) == list(range(len(rijs)))


def test_delay_sites_follow_the_program(outlier_stream):
    """A pipeline takes the one-band table where the JAX program fuses the
    delays (one band, float32, four C-steps, integer lags) and no site
    elsewhere: two bands, bfloat16, other C-step counts, sub-sample delays,
    OLS."""
    st = outlier_stream
    rij = get_rij(st.latitudes, st.longitudes, st.nchans)
    one = tplan.make_plan([0.3, 1.2], "linear", [30.0], 0.5, st.npts, st.fs)
    _, two = _plans(st, 2, "constant")
    sites = lambda plan, **kw: NarrowBandPipeline(plan, rij, device="cpu", **kw)._delay_sites
    assert sites(one, alpha=0.75) == TL.delay_contracted(15, "exhaustive")
    assert sites(one, alpha=0.75, lts_funnel_k=16) == TL.delay_contracted(15, "funnel")
    assert sites(one, alpha=0.75, lts_candidate_chunk=17) == TL.delay_contracted(15, "chunk")
    for plan, kw in ((two, {}), (one, {"c_steps": 3}), (one, {"subsample_delays": True}),
                     (one, {"dtype": torch.bfloat16, "apply_filter": False})):
        assert sites(plan, alpha=0.75, **kw) == frozenset(), kw
    assert sites(one) == frozenset()
