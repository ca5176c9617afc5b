"""PyTorch port: the streaming monitor (`models.StreamingMonitor`) on the
CPU: segmentation, persistence, resume, retry and assembly, mirroring
``tests/test_streaming.py`` case by case, and against the JAX package's
monitor on the same stream.

The stream and plan are ``tests/test_streaming.py``'s: 1000 s of a
4-element array at 10 Hz in five 200 s segments, 2 log bands over
0.3-1.5 Hz, 30 s windows.  Against JAX the window times and counts are
equal exactly, and vel/baz/MdCCM/sig_tau agree within 1e-4 on every window
with MdCCM > 0.6 and on at least 99% of the valid windows.
"""

import os

import numpy as np
import pytest
import torch

from narrow_band_least_squares_tpu.io.synthetic import synthetic_plane_wave
from narrow_band_least_squares_tpu.models.streaming import StreamingMonitor as JMonitor
from narrow_band_least_squares_tpu.utils.geometry import get_rij
from narrow_band_least_squares_tpu.utils.plan import get_freqlist, get_winlenlist, make_plan
from narrow_band_least_squares_tpu_torch.models import StreamingMonitor
from narrow_band_least_squares_tpu_torch.models import streaming as tstreaming
from narrow_band_least_squares_tpu_torch.utils import plan as tplan

from test_torch_pipeline import _tstream

TOL = 1e-4


@pytest.fixture(scope="module")
def monitor_setup(tmp_path_factory):
    st = synthetic_plane_wave(
        nchans=4, duration_s=1000.0, fs=10.0, baz_deg=45.0,
        trace_vel_kms=0.33, f0=0.6, bandwidth=0.8, snr=10.0, seed=33,
    )
    freqlist, nbands, _ = get_freqlist(0.3, 1.5, "log", 2)
    winlens = get_winlenlist("constant", nbands, 30, 0, 0)
    args = (freqlist, "log", winlens, 0.5, int(200 * st.fs), st.fs)
    rij = get_rij(st.latitudes, st.longitudes, st.nchans)
    save_dir = str(tmp_path_factory.mktemp("mon"))
    mon = StreamingMonitor(tplan.make_plan(*args), rij, save_dir, freqlist,
                           alpha=1.0, device="cpu")
    mon.process(_tstream(st))
    return _tstream(st), mon, save_dir, (st, make_plan(*args), rij, freqlist)


def _monitor(mon, save_dir, **kw):
    """Another port monitor on ``mon``'s plan and geometry."""
    return StreamingMonitor(mon.plan, mon.pipe.base.rij, str(save_dir), mon.freqlist,
                            device="cpu", **{"alpha": 1.0, **kw})


def test_process_and_resume(monitor_setup, tmp_path):
    """Mirror of ``test_streaming.py:33``."""
    st, mon, _, _ = monitor_setup
    mon2 = _monitor(mon, tmp_path)
    recs = mon2.process(st)
    assert len(recs) == 5  # 1000 s / 200 s segments
    assert len([f for f in os.listdir(tmp_path) if f.endswith(".txt")]) == 5
    assert mon2.process(st) == []          # resume: nothing left to do
    os.remove(recs[2].path_txt)            # a deleted segment is redone, alone
    recs3 = mon2.process(st)
    assert len(recs3) == 1
    assert abs(recs3[0].start_epoch - recs[2].start_epoch) < 1e-6


def test_atomic_persist_and_stray_tmp_files(monitor_setup):
    """Mirror of ``test_streaming.py:49``: debris of an interrupted write
    (*.tmp) is ignored by the resume scan and read_all, and the writer
    leaves none."""
    st, mon, save_dir, _ = monitor_setup
    before = mon.read_all()
    junk = ("nbls_999.txt.tmp", "nbls_999.npz.tmp.npz")
    for name in junk:
        with open(os.path.join(save_dir, name), "w") as f:
            f.write("partial")
    try:
        assert mon.process(st) == []
        np.testing.assert_array_equal(before[0], mon.read_all()[0])
        assert not any(f.endswith(".tmp") or f.endswith(".tmp.npz")
                       for f in os.listdir(save_dir) if not f.startswith("nbls_999"))
    finally:
        for name in junk:
            os.remove(os.path.join(save_dir, name))


def test_read_all_assembles(monitor_setup):
    """Mirror of ``test_streaming.py:76``."""
    _, mon, _, _ = monitor_setup
    vel, baz, mdccm, t, num = mon.read_all()
    assert vel.shape[0] == mon.plan.nbands and len(num) == mon.plan.nbands
    for b in range(mon.plan.nbands):
        assert np.all(np.diff(t[b, : num[b]]) > 0)
    good = mdccm > 0.6
    assert good.sum() > 0
    d = np.abs((baz[good] - 45.0 + 180.0) % 360.0 - 180.0)
    assert np.median(d) < 6.0


@pytest.fixture(scope="module")
def jax_monitor(monitor_setup, tmp_path_factory):
    """The JAX package's monitor on the same stream, once."""
    st, plan, rij, freqlist = monitor_setup[3]
    save_dir = str(tmp_path_factory.mktemp("jaxmon"))
    jmon = JMonitor(plan, rij, save_dir, freqlist, alpha=1.0)
    jmon.process(st)
    return jmon.read_all(extras=True)


def test_read_all_matches_jax_monitor(monitor_setup, jax_monitor):
    """The port's persisted results against JAX's: window times and counts
    exactly, vel/baz/MdCCM/sig_tau within 1e-4 on confident windows and on
    at least 99% of the valid ones."""
    got = monitor_setup[1].read_all(extras=True)
    want = jax_monitor
    assert got[4] == want[4]
    np.testing.assert_array_equal(got[3], want[3])
    valid = np.zeros(got[0].shape, dtype=bool)
    for b, n in enumerate(got[4]):
        valid[b, :n] = True
    conf = valid & (want[2] > 0.6)
    assert conf.sum() > 10
    close = np.ones_like(valid)
    for g, w, circ in ((got[0], want[0], False), (got[1], want[1], True),
                       (got[2], want[2], False),
                       (got[5]["sig_tau"], want[5]["sig_tau"], False)):
        d = np.abs((g - w + 180.0) % 360.0 - 180.0) if circ else np.abs(g - w)
        close &= d <= TOL + TOL * np.abs(w)
    assert close[conf].all()
    assert close[valid].mean() >= 0.99


def test_retry_on_transient_failure(monitor_setup, tmp_path, monkeypatch):
    """Mirror of ``test_streaming.py:110``: one failed dispatch is re-run
    synchronously, once."""
    st, mon, _, _ = monitor_setup
    mon2 = _monitor(mon, tmp_path, max_retries=1)
    calls = {"async": 0, "sync": 0}
    real_async, real_sync = mon2.pipe.run_extended_async, mon2.pipe.run_extended

    def flaky_async(x_ext):
        calls["async"] += 1
        if calls["async"] == 1:
            raise RuntimeError("transient device error")
        return real_async(x_ext)

    def counted_sync(x_ext):
        calls["sync"] += 1
        return real_sync(x_ext)

    monkeypatch.setattr(mon2.pipe, "run_extended_async", flaky_async)
    monkeypatch.setattr(mon2.pipe, "run_extended", counted_sync)
    assert len(mon2.process(st)) == 5
    assert calls["sync"] == 1


def test_retry_exhaustion_raises(monitor_setup, tmp_path, monkeypatch):
    """Mirror of ``test_streaming.py:140``; the failed segments are
    un-queued, so a later submit selects them again."""
    st, mon, _, _ = monitor_setup
    mon2 = _monitor(mon, tmp_path, max_retries=1)

    def always_fail(x_ext):
        raise RuntimeError("persistent device error")

    monkeypatch.setattr(mon2.pipe, "run_extended_async", always_fail)
    monkeypatch.setattr(mon2.pipe, "run_extended", always_fail)
    with pytest.raises(RuntimeError, match="persistent"):
        mon2.process(st)
    first_batch = [t0 for _, t0 in mon2.segment_starts(st)][: mon2.batch]
    assert not set(first_batch) & mon2._queued


def test_cuda_error_is_not_retried(monitor_setup, tmp_path, monkeypatch):
    """A CUDA error may leave the context unusable: the batch is not
    re-run (on the card or anywhere else), the error propagates."""
    st, mon, _, _ = monitor_setup
    mon2 = _monitor(mon, tmp_path, max_retries=3)
    calls = {"sync": 0}

    def fault(x_ext):
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    def counted_sync(x_ext):
        calls["sync"] += 1
        raise AssertionError("a CUDA error must not be retried")

    monkeypatch.setattr(mon2.pipe, "run_extended_async", fault)
    monkeypatch.setattr(mon2.pipe, "run_extended", counted_sync)
    with pytest.raises(RuntimeError, match="illegal memory access"):
        mon2.process(st)
    assert calls["sync"] == 0


def test_overlapping_submit_no_duplicates(monitor_setup, tmp_path):
    """Mirror of ``test_streaming.py:159``."""
    st, mon, _, _ = monitor_setup
    mon2 = _monitor(mon, tmp_path)
    n = len(mon2.segment_starts(st))
    mon2.submit(st)
    mon2.submit(st)      # overlapping re-submit before anything persisted
    recs = mon2.flush()
    assert len(recs) == n
    assert len({r.start_epoch for r in recs}) == n
    assert len([f for f in os.listdir(tmp_path) if f.endswith(".txt")]) == n


def test_submit_snapshots_before_return(monitor_setup, tmp_path):
    """Mirror of ``test_streaming.py:177``: a caller that reuses one buffer
    per fed segment gets the results of fresh buffers, bit for bit."""
    st, mon, _, _ = monitor_setup
    mon2 = _monitor(mon, tmp_path / "reused", dispatch_segments=4)
    mon3 = _monitor(mon, tmp_path / "fresh", dispatch_segments=4)
    Tseg = mon2.plan.npts
    buf = np.empty((st.nchans, Tseg))
    nseg = st.npts // Tseg
    for k in range(nseg):
        chunk = st.data[:, k * Tseg : (k + 1) * Tseg]
        t0 = st.start_epoch + k * Tseg / st.fs
        buf[:] = chunk
        mon2.submit(type(st)(data=buf, fs=st.fs, start_epoch=t0,
                             latitudes=st.latitudes, longitudes=st.longitudes))
        buf[:] = -1e9          # clobber: must not affect queued segments
        mon3.submit(type(st)(data=chunk.copy(), fs=st.fs, start_epoch=t0,
                             latitudes=st.latitudes, longitudes=st.longitudes))
    assert len(mon2.flush()) == nseg
    assert len(mon3.flush()) == nseg
    v3, b3, m3, t3, n3 = mon3.read_all()
    v2, b2, m2, t2, n2 = mon2.read_all()
    assert n3 == n2
    np.testing.assert_array_equal(v2, v3)
    np.testing.assert_array_equal(m2, m3)


def test_bfloat16_transfer_mode(monitor_setup, tmp_path):
    """Mirror of ``test_streaming.py:221``: the bfloat16 wire quantizes
    only the raw samples; confident windows stay within the input-noise
    envelope of the float32 wire."""
    st, mon, _, _ = monitor_setup
    mon2 = _monitor(mon, tmp_path, transfer_dtype="bfloat16")
    assert mon2.pipe.transfer_dtype.itemsize == 2
    mon2.process(st)
    v1, b1, m1, t1, n1 = mon.read_all()
    v2, b2, m2, t2, n2 = mon2.read_all()
    assert n1 == n2
    good = (m1 > 0.6) & (m2 > 0.6)
    assert good.sum() > 10
    d = np.abs((b1[good] - b2[good] + 180.0) % 360.0 - 180.0)
    assert np.median(d) < 1.0 and d.max() < 10.0
    assert np.median(np.abs(v1[good] - v2[good])) < 0.01


def test_lts_monitor_persists_flags(monitor_setup, tmp_path):
    """Mirror of ``test_streaming.py:243``: LTS flags ride as the second
    copy and land in each segment's npz; ``read_all(extras=True)``
    reassembles the npz-only arrays, also after a resume and with a
    sidecar missing.  The monitoring figure is not ported yet (ROADMAP.md
    Queue 1 item 7); the arrays it would draw are checked instead."""
    st, mon, _, _ = monitor_setup
    mon2 = _monitor(mon, tmp_path, alpha=0.8)
    recs = mon2.process(st)
    assert len(recs) == 5
    z0 = np.load(recs[0].path_npz)
    B, Wmax = mon.plan.nbands, mon.plan.max_windows
    P = mon2.pipe.base.pairs_np.shape[0]
    assert z0["flags"].shape == (B, Wmax, P) and z0["flags"].dtype == bool
    assert z0["vel_uncert"].shape == z0["vel"].shape
    assert z0["baz_uncert"].shape == z0["baz"].shape

    vel, baz, mdccm, t, num, ex = mon2.read_all(extras=True)
    width = vel.shape[1]
    for k in ("sig_tau", "vel_uncert", "baz_uncert"):
        assert ex[k].shape == (B, width)
    assert ex["flags"].shape == (B, width, P)
    for b in range(B):
        n = num[b]
        assert np.isfinite(ex["sig_tau"][b, :n]).all()
        assert np.isfinite(ex["vel_uncert"][b, :n]).all()
        assert np.isfinite(ex["baz_uncert"][b, :n]).all()
    n0 = int(z0["num_compute"][0])
    np.testing.assert_allclose(ex["sig_tau"][0, :n0], z0["sig_tau"][0, :n0])
    np.testing.assert_array_equal(ex["flags"][0, :n0], z0["flags"][0, :n0])
    assert ex["flags"].any()

    mon3 = _monitor(mon, tmp_path, alpha=0.8)
    assert mon3.process(st) == []
    _, _, _, _, num2, ex2 = mon3.read_all(extras=True)
    assert num2 == num
    np.testing.assert_allclose(ex2["sig_tau"], ex["sig_tau"])
    np.testing.assert_array_equal(ex2["flags"], ex["flags"])

    os.remove(recs[1].path_npz)
    _, _, _, _, num3, ex3 = mon3.read_all(extras=True)
    assert num3 == num
    assert np.isfinite(ex3["sig_tau"][0, :n0]).all()
    assert np.isnan(ex3["sig_tau"][0, n0 : n0 + 1]).any()

    # what the uncertainty figure draws: confident windows' uncertainties
    # on the time axis, and per-element flag counts
    good = mdccm > 0.6
    assert good.sum() > 0 and np.isfinite(ex["vel_uncert"][good]).all()
    counts = np.zeros(st.nchans)
    for p, (i, j) in enumerate(mon2.pipe.base.pairs_np):
        counts[i] += ex["flags"][..., p].sum()
        counts[j] += ex["flags"][..., p].sum()
    assert counts.sum() == 2 * ex["flags"].sum()


def test_nan_guard_zeroes_non_finite():
    got = tstreaming._nan_guard(np.array([1.0, np.nan, np.inf, -np.inf, -2.0]))
    np.testing.assert_array_equal(got, [1.0, 0.0, 0.0, 0.0, -2.0])


def test_what_is_refused_raises(monitor_setup, tmp_path, monkeypatch):
    """A mesh must be a `parallel.mesh.Mesh`; several processes need one
    (without it each would run and persist the whole stream)."""
    _, mon, _, _ = monitor_setup
    with pytest.raises(TypeError, match="parallel.mesh.Mesh"):
        _monitor(mon, tmp_path, mesh=object())
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda *a: 2)
    with pytest.raises(ValueError, match="needs a mesh"):
        _monitor(mon, tmp_path)


def test_context_manager_closes_the_writer(monitor_setup, tmp_path):
    """Leaving the block drains the queue and stops the writer thread; with
    one batch in flight at most, the second dispatch drains the first."""
    st, mon, _, _ = monitor_setup
    with _monitor(mon, tmp_path, dispatch_segments=2) as mon2:
        assert mon2.batch == 2
        assert mon2.submit(st, dispatch_depth=1) == 5
        assert len(mon2._inflight) == 1 and len(mon2._backlog) == 1
        assert mon2._pool is not None
    assert mon2._pool is None
    assert len([f for f in os.listdir(tmp_path) if f.endswith(".txt")]) == 5
