"""PyTorch port: sub-sample delays (``subsample_delays=True``) against the
JAX package on the CPU.

The port refines each integer-lag peak with the three-point parabola
through it and its two neighbouring correlations, which ``icorr_peak``
returns beside the peak (`ops.xcorr.subsample_frac`); the JAX package
carries the same neighbours through its lag tiles
(``narrow_band_least_squares_tpu/ops/xcorr.py:233-311``).  Tolerances are
the JAX package's own tiled-against-untiled ones
(``tests/test_xcorr_methods.py:242-290``): integer lags exact, tau within
2e-4/fs, rho and MdCCM within 2e-5.  Through the pipelines vel/baz/MdCCM/
sig_tau agree within 1e-4 on windows whose integer lags are equal (all of
them on these inputs), and LTS flags follow the near-tie rules of
``tests/test_torch_lts_pipeline.py`` (``ROADMAP.md`` Queue 3).
"""

import json
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from narrow_band_least_squares_tpu import api as japi
from narrow_band_least_squares_tpu.io.synthetic import synthetic_plane_wave
from narrow_band_least_squares_tpu.models.multiarray import MultiArrayPipeline as JMulti
from narrow_band_least_squares_tpu.models.narrowband import NarrowBandPipeline as JPipe
from narrow_band_least_squares_tpu.models.streaming import StreamingMonitor as JMonitor
from narrow_band_least_squares_tpu.ops import xcorr as JXC
from narrow_band_least_squares_tpu.utils.geometry import get_rij
from narrow_band_least_squares_tpu.utils.plan import get_freqlist, get_winlenlist, make_plan
from narrow_band_least_squares_tpu_torch import api as tapi
from narrow_band_least_squares_tpu_torch.__main__ import main as tmain
from narrow_band_least_squares_tpu_torch.models import (
    MultiArrayPipeline,
    NarrowBandPipeline,
    StreamingMonitor,
)
from narrow_band_least_squares_tpu_torch.ops import xcorr as TXC
from narrow_band_least_squares_tpu_torch.ops.kernels import xcorr_peak as XP
from narrow_band_least_squares_tpu_torch.utils import plan as tplan

from test_torch_cli import cfg_json, restore_perf_defaults, stream_npz  # noqa: F401
from test_torch_lts_pipeline import (  # noqa: F401  (delays: a fixture)
    MIN_SAME,
    _close as _close_where,
    _refit_close,
    _sweeps,
    _trimmed,
    delays,
)
from test_torch_multiarray import arrays  # noqa: F401  (fixture)
from test_torch_pipeline import OUTS, _close, _plans, _tstream
from test_torch_sharding import _pair
from test_torch_sharding import _close as _close_sharded
from test_torch_sharding import long_stream  # noqa: F401  (fixture)

TAU_TOL = 2e-4      # samples: tests/test_xcorr_methods.py:285
XTOL = 2e-5         # rho and MdCCM: tests/test_xcorr_methods.py:287-290


def _differ(pipe, ours, theirs, tau, where, X):
    """Windows in ``where`` whose flags differ, each checked: the port's
    retained set is no worse an LTS solution than JAX's (float64
    criteria), and at most one window in 50 (at least one) differs, with
    the funnel too.  Returns them.  Sub-sample delays agree only within
    TAU_TOL, so a near-tied subset may go either way here."""
    out = []
    for b, w in np.argwhere(where & (ours != theirs).any(-1)):
        a = _trimmed(tau[b, w], X, ~ours[b, w], pipe.h)
        c = _trimmed(tau[b, w], X, ~theirs[b, w], pipe.h)
        assert a <= c * (1 + 1e-6), f"window {(b, w)}: LTS criterion {a} against JAX's {c}"
        out.append((int(b), int(w)))
    assert len(out) <= max(1, where.sum() // 50), out
    return out


def _jax_tables(tab):
    return {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v) for k, v in tab.items()}


def _torch_tables(tab):
    return {k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v)
            for k, v in tab.items()}


def _tiled_batch():
    """``tests/test_xcorr_methods.py:256``'s windows: 3 bands, 4 windows,
    5 elements, 130 samples at 20 Hz, each band with its own lag range."""
    rng = np.random.default_rng(7)
    B, W, C, L = 3, 4, 5, 130
    win = rng.standard_normal((B, W, C, L))
    win -= win.mean(axis=-1, keepdims=True)
    pairs = np.array([[i, j] for i in range(C) for j in range(i + 1, C)], np.int32)
    nlag = 2 * L - 1
    lag_mask = np.zeros((B, nlag), bool)
    for b, half in enumerate([L - 1, 90, 40]):
        lag_mask[b, L - 1 - half: L + half] = True
    return win.astype(np.float32), pairs, lag_mask, L


@pytest.mark.parametrize("lag_tile", [32, 100, 256, 512])
def test_subsample_matches_jax_lag_tiled(lag_tile):
    """Mirror of ``test_xcorr_methods.py:242``: the port against JAX's
    ``cross_correlate_mxu(subsample=True)`` at each lag tile."""
    win, pairs, lag_mask, L = _tiled_batch()
    fs = 20.0
    tab = JXC.precompute_dft_tables(L, np.float32)
    jrun = lambda sub: jax.jit(lambda w: JXC.cross_correlate_mxu(
        w, jnp.asarray(pairs), jnp.asarray(lag_mask), _jax_tables(tab), fs,
        subsample=sub, lag_tile=lag_tile))(jnp.asarray(win))
    trun = lambda sub: TXC.cross_correlate_mxu(
        torch.from_numpy(win), torch.from_numpy(pairs).long(),
        torch.from_numpy(lag_mask), _torch_tables(tab), fs, subsample=sub)
    want, want_int = jrun(True), jrun(False)
    got, got_int = trun(True), trun(False)
    # integer lags exact...
    np.testing.assert_array_equal(got_int[0].numpy(), np.asarray(want_int[0]))
    np.testing.assert_array_equal(np.round(got[0].numpy() * fs), np.round(np.asarray(want[0]) * fs))
    # ...and the parabola's frac, rho and MdCCM at float tolerance
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=TAU_TOL / fs)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), atol=XTOL)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), atol=XTOL)
    assert not np.array_equal(got[0].numpy(), got_int[0].numpy())


def test_subsample_recovers_fractional_delay():
    """Mirror of ``test_xcorr_methods.py:204``: a 3.3-sample delay of a
    band-limited wave; the refined delay beats the integer one and lands
    within 0.02 s, as JAX's does, within 2e-4 samples of it."""
    rng = np.random.default_rng(11)
    fs, L, n = 10.0, 400, 4096
    src = rng.standard_normal(n)
    S = np.fft.rfft(src)
    f = np.fft.rfftfreq(n, 1 / fs)
    S[(f < 0.3) | (f > 1.5)] = 0
    src = np.fft.irfft(S, n)
    true_delay = 0.33
    shifted = np.fft.irfft(np.fft.rfft(src) * np.exp(-2j * np.pi * f * true_delay), n)
    a, b = src[1000:1000 + L], shifted[1000:1000 + L]
    win = np.zeros((1, 1, 2, L), dtype=np.float32)
    win[0, 0, 0], win[0, 0, 1] = a - a.mean(), b - b.mean()
    pairs = np.array([[0, 1]], dtype=np.int32)
    lag_mask = np.ones((1, 2 * L - 1), dtype=bool)
    tab = JXC.precompute_dft_tables(L, np.float64)
    ttab = _torch_tables(JXC.precompute_dft_tables(L, np.float32))
    args = (torch.from_numpy(win), torch.from_numpy(pairs).long(),
            torch.from_numpy(lag_mask), ttab, fs)
    tau_int = float(TXC.cross_correlate_mxu(*args)[0][0, 0, 0])
    tau_sub = float(TXC.cross_correlate_mxu(*args, subsample=True)[0][0, 0, 0])
    want = float(JXC.cross_correlate_mxu(jnp.asarray(win), jnp.asarray(pairs),
                                         jnp.asarray(lag_mask), _jax_tables(tab), fs,
                                         subsample=True)[0][0, 0, 0])
    err_int, err_sub = abs(tau_int - true_delay), abs(tau_sub - true_delay)
    assert err_int <= 0.5 / fs + 1e-6
    assert err_sub < err_int and err_sub < 0.02
    assert abs(tau_sub - want) <= TAU_TOL / fs


@pytest.mark.parametrize("precision", ["highest", "high", "default"])
def test_icorr_peak_neighbours_are_the_unmasked_columns(precision):
    """The plain version with neighbours: (peak, idx) those of the integer
    search; (cm, cp) the product's columns idx -/+ 1 even outside [lo, hi];
    0 at lag 0 and nlag - 1 and for a row with no valid lag."""
    rng = np.random.default_rng(5)
    R, K2, nlag = 40, 64, 300
    cs2 = torch.from_numpy(rng.standard_normal((R, K2)).astype(np.float32))
    e2 = torch.from_numpy(rng.standard_normal((K2, nlag)).astype(np.float32))
    lo = torch.from_numpy(rng.integers(0, 200, R).astype(np.int32))
    hi = lo + torch.from_numpy(rng.integers(0, 100, R).astype(np.int32))
    lo[:3] = 0                      # peaks may sit at lag 0...
    hi[3:6] = nlag - 1              # ...or nlag - 1
    lo[6], hi[6] = 5, 4             # no valid lag
    pk, ix, cm, cp = XP.icorr_peak_reference(cs2, e2, lo, hi, precision, neighbours=True)
    pk0, ix0 = XP.icorr_peak_reference(cs2, e2, lo, hi, precision)
    assert torch.equal(pk, pk0) and torch.equal(ix, ix0)
    cc = XP._product(cs2, e2, precision)
    for r in range(R):
        k = int(ix[r])
        if r == 6:
            assert torch.isneginf(pk[r]) and k == 0 and cm[r] == 0 and cp[r] == 0
            continue
        assert cm[r] == (cc[r, k - 1] if k > 0 else 0.0)
        assert cp[r] == (cc[r, k + 1] if k < nlag - 1 else 0.0)
    # the CPU route of the wrapper is the plain version in IEEE fp32
    got = XP.icorr_peak(cs2, e2, lo, hi, precision=precision, neighbours=True)
    want = XP.icorr_peak_reference(cs2, e2, lo, hi, neighbours=True)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_subsample_frac_rule():
    """`subsample_frac` against the JAX package's rule: 0 where |denom| <=
    1e-20 or idx is 0 or nlag - 1, clipped to +-0.5."""
    peak = torch.tensor([1.0, 1.0, 1.0, 1.0, 1.0, 1.0])
    cm = torch.tensor([0.5, 0.9, 1.0, 0.5, 0.5, 0.5])
    cp = torch.tensor([0.7, 0.2, 1.0, 0.7, 0.7, 2.0])
    idx = torch.tensor([5, 5, 5, 0, 9, 5], dtype=torch.int32)
    got = TXC.subsample_frac(peak, cm, cp, idx, 10).numpy()
    j_denom = cm.numpy() - 2.0 * peak.numpy() + cp.numpy()
    ok = (np.abs(j_denom) > 1e-20) & (idx.numpy() > 0) & (idx.numpy() < 9)
    want = np.clip(np.where(ok, 0.5 * (cm.numpy() - cp.numpy()) / np.where(ok, j_denom, 1.0),
                            0.0), -0.5, 0.5)
    np.testing.assert_array_equal(got, want.astype(np.float32))
    assert got[2] == 0 and got[3] == 0 and got[4] == 0 and got[5] == -0.5


# --------------------------------------------------------------------------
# the pipelines
# --------------------------------------------------------------------------

PIPE_CASES = [
    ("bucketed", 4, "adaptive", {}),
    ("unbucketed", 4, "adaptive", {"bucket_bands": False}),
    ("maxlag", 4, "adaptive", {"max_lag_s": 1.5}),
    ("maxlag-unbucketed", 4, "adaptive", {"max_lag_s": 1.5, "bucket_bands": False}),
    ("gather", 2, "constant", {"window_method": "gather"}),
]


@pytest.mark.parametrize("name,nbands,kind,kw", PIPE_CASES, ids=[c[0] for c in PIPE_CASES])
def test_pipeline_subsample_matches_jax(small_stream, name, nbands, kind, kw):
    """NarrowBandPipeline with ``subsample_delays=True``, 'mxu': every
    output within 1e-4 of JAX's, and the refinement really moves vel."""
    st = small_stream
    jp, tp = _plans(st, nbands, kind)
    rij = get_rij(st.latitudes, st.longitudes, st.nchans)
    want = JPipe(jp, rij, subsample_delays=True, **kw).run_raw(st.data)
    pipe = NarrowBandPipeline(tp, rij, subsample_delays=True, device="cpu", **kw)
    assert pipe.subsample_delays
    got = pipe.run_raw(st.data)
    _close(got, want, OUTS)
    plain = NarrowBandPipeline(tp, rij, device="cpu", **kw).run_raw(st.data)
    assert float((got["vel"] - plain["vel"]).abs().max()) > 1e-5


@pytest.mark.parametrize("method", ["pallas", "fused", "fft"])
def test_subsample_ignored_as_jax(small_stream, method, caplog):
    """'pallas' and 'fused' ignore the flag with a warning, 'fft' silently,
    as in the JAX package: the outputs equal the run without it."""
    st = small_stream
    _, tp = _plans(st, 2, "constant")
    rij = get_rij(st.latitudes, st.longitudes, st.nchans)
    with caplog.at_level(logging.WARNING, logger="nbls_torch"):
        pipe = NarrowBandPipeline(tp, rij, xcorr_method=method, subsample_delays=True,
                                  device="cpu")
    assert ("subsample_delays is ignored" in caplog.text) == (method != "fft")
    assert not pipe.subsample_delays
    ref = NarrowBandPipeline(tp, rij, xcorr_method=method, device="cpu").run_raw(st.data)
    got = pipe.run_raw(st.data)
    for k in ref:
        assert torch.equal(got[k], ref[k]), k


def test_api_subsample_matches_jax(small_stream):
    """``narrow_band_least_squares`` and ``ltsva`` under
    ``set_performance_defaults(subsample_delays=True)``."""
    st = small_stream
    fl, nb, _ = get_freqlist(0.3, 1.5, "log", 3)
    wl = get_winlenlist("adaptive", nb, 0, 40, 20)
    fr = np.logspace(-2, np.log10(st.fs / 2), 20)
    args = (wl, 0.5, 1.0)
    tail = (st.latitudes, st.longitudes, nb, None, None, fl, "log", fr, "cheby1", 2, 0.01)
    japi.set_performance_defaults(subsample_delays=True)
    tapi.set_performance_defaults(subsample_delays=True)
    try:
        want = japi.narrow_band_least_squares(*args, st, *tail)
        got = tapi.narrow_band_least_squares(*args, _tstream(st), *tail, device="cpu")
        jl = japi.ltsva(st, st.latitudes, st.longitudes, 30.0, 0.5, 1.0)
        tl = tapi.ltsva(_tstream(st), st.latitudes, st.longitudes, 30.0, 0.5, 1.0,
                        device="cpu")
    finally:
        japi.set_performance_defaults(subsample_delays=None)
        tapi.set_performance_defaults(subsample_delays=None)
    for i in (0, 1, 2, 5):
        np.testing.assert_allclose(got[i], want[i], rtol=1e-4, atol=1e-4)
    for i in (0, 1, 3, 5):
        np.testing.assert_allclose(tl[i], jl[i], rtol=1e-4, atol=1e-4)


def _check_lts(pipe, got, want, delays, run, geometry):
    """LTS with sub-sample delays, one array: the rules of
    ``tests/test_torch_lts_pipeline.py::_check`` with refined delays, which
    differ between the two packages in their last bits (the parabola
    divides differences of correlations that sum in other orders).  The
    recorded delays agree within TAU_TOL samples on MIN_SAME of the valid
    windows; on JAX's delays the port's sweep flags what JAX's does (with
    the funnel: `_differ`'s bound); the whole runs may differ only as
    `_differ` allows; vel/baz/sig_tau agree within 1e-4 on the windows whose
    delays and flags agree; the port's estimates are the fit of its own
    retained pairs on every window."""
    jax.effects_barrier()
    X = geometry["X"].numpy()
    tau_t = [t for x, t in delays["torch"] if np.array_equal(x, X)][run]
    wm = pipe.state_dict()["win_mask"].numpy()
    near = lambda t: (np.abs(t - tau_t) <= TAU_TOL / pipe.plan.fs).all(-1) & wm
    cands = [t for x, t in delays["jax"] if np.array_equal(x, X)]
    tau_j = max(cands, key=lambda t: near(t).sum())
    same = near(tau_j)
    assert same.sum() >= MIN_SAME * wm.sum()
    ours, theirs = _sweeps(pipe, tau_j, geometry)
    X64 = X.astype(np.float64)
    _differ(pipe, ours, theirs, tau_j, wm, X64)
    for b, w in _differ(pipe, got["flags"].numpy(), want["flags"], tau_t, same, X64):
        same[b, w] = False
    _close_where(got, want, ("vel", "baz", "sig_tau"), where=same)
    _refit_close(pipe, got, tau_t, X64)


MULTI = [
    ("funnel-subsamp", dict(alpha=0.75, lts_funnel_k=4, subsample_delays=True)),
    ("ols-maxlag-subsamp", dict(alpha=1.0, max_lag_s=8.0, subsample_delays=True)),
]


@pytest.mark.parametrize("kw", [m[1] for m in MULTI], ids=[m[0] for m in MULTI])
def test_multiarray_subsample_matches_jax(arrays, delays, kw):  # noqa: F811
    """The ``tests/test_multiarray.py:130-131`` cases: each merged array
    against the JAX batch (LTS: `_check`'s rules), and its single-array
    run."""
    data, jp, tp, rijs = arrays
    want = JMulti(jp, rijs, **kw).run_raw(data)
    multi = MultiArrayPipeline(tp, rijs, device="cpu", **kw)
    got = multi.run_raw(data)
    for k, rij in enumerate(rijs):
        g = {n: v[k] for n, v in got.items()}
        w = {n: np.asarray(v[k]) for n, v in want.items()}
        if kw["alpha"] < 1.0:
            _check_lts(multi.base, g, w, delays, k, multi._geometry[k])
        else:
            _close(g, w, OUTS)
        one = NarrowBandPipeline(tp, rij, device="cpu", **kw).run_raw(data[k])
        _close(g, one, OUTS)


@pytest.mark.parametrize("case", ["core-4x1", "global-2x4", "bucket-2x4"])
def test_sharded_subsample_matches_jax(long_stream, case):  # noqa: F811
    """The sharded pipeline's "core" (band axis unsharded: the base
    pipeline), "global" and slot-"bucket" modes with subsample delays on a
    virtual mesh against JAX's sharded run."""
    mode, shape = case.split("-")
    nt, nb = (int(v) for v in shape.split("x"))
    kw = {"subsample_delays": True}
    if mode == "global":
        kw["bucket_bands"] = False
    j, t, segs = _pair(long_stream, nt, nb, **kw)
    assert t._mode == j._mode == mode
    got = t.run_reference_sequential(segs)
    _close_sharded(got, j.run(segs))
    _, plain, _ = _pair(long_stream, nt, nb, **{k: v for k, v in kw.items()
                                                 if k != "subsample_delays"})
    assert not np.allclose(got["vel"], plain.run_reference_sequential(segs)["vel"],
                           atol=1e-6)


def test_monitor_subsample_matches_jax(tmp_path):
    """``StreamingMonitor(subsample_delays=True)``: the persisted results
    equal JAX's monitor within 1e-4 (window times and counts exactly)."""
    st = synthetic_plane_wave(nchans=4, duration_s=600.0, fs=10.0, baz_deg=45.0,
                              trace_vel_kms=0.33, f0=0.6, bandwidth=0.8, snr=10.0,
                              seed=33)
    fl, nb, _ = get_freqlist(0.3, 1.5, "log", 2)
    wl = get_winlenlist("constant", nb, 30, 0, 0)
    args = (fl, "log", wl, 0.5, int(200 * st.fs), st.fs)
    rij = get_rij(st.latitudes, st.longitudes, st.nchans)
    jmon = JMonitor(make_plan(*args), rij, str(tmp_path / "j"), fl, subsample_delays=True)
    jmon.process(st)
    tmon = StreamingMonitor(tplan.make_plan(*args), rij, str(tmp_path / "t"), fl,
                            subsample_delays=True, device="cpu")
    assert tmon.pipe.base.subsample_delays
    tmon.process(_tstream(st))
    got, want = tmon.read_all(), jmon.read_all()
    assert got[4] == want[4]
    np.testing.assert_array_equal(got[3], want[3])
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4)


def test_cli_subsample_delays(stream_npz, cfg_json, tmp_path, capsys,  # noqa: F811
                              restore_perf_defaults):  # noqa: F811
    """``run --subsample-delays`` and ``monitor --subsample-delays`` reach
    the pipelines: ``run`` sets the option for the API (and finds the
    synthetic source), ``monitor``'s pipeline refines its delays."""
    for flag in ([], ["--subsample-delays"]):
        tmain(["run", "--data", stream_npz, "--out", str(tmp_path / f"r{len(flag)}"),
               "--no-figures", "--config", cfg_json, "--device", "cpu", *flag])
        assert tapi._PERF_DEFAULTS.get("subsample_delays", False) == bool(flag)
        summary = json.loads(capsys.readouterr().out)
        assert summary["median_baz_deg"] == pytest.approx(230.0, abs=8.0)
    seen = []
    real = StreamingMonitor.__init__

    def spy(self, *a, **kw):
        real(self, *a, **kw)
        seen.append(self.pipe.base.subsample_delays)

    StreamingMonitor.__init__ = spy
    try:
        tmain(["monitor", "--data", stream_npz, "--out", str(tmp_path / "m"),
               "--config", cfg_json, "--device", "cpu", "--segment-s", "120",
               "--subsample-delays"])
    finally:
        StreamingMonitor.__init__ = real
    assert seen == [True]
    assert json.loads(capsys.readouterr().out)["segments_processed"] == 2
