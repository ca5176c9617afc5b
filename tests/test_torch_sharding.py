"""PyTorch port: the sharded pipeline (`parallel.ShardedNarrowBandPipeline`
over a (time, band) mesh) against the JAX package's on the CPU.

Mirrors ``tests/test_sharding.py:65-242``.  The stream and plan are that
file's ``long_stream`` setup: 1600 s of a 4-element array at 10 Hz in eight
200 s segments, 4 log bands over 0.2-1.6 Hz (the worker's ``small``
workload).  On a *virtual* mesh (``mesh_shape=(nt, nb)``, one process) the
port's ``run_reference_sequential`` is held against JAX's sharded ``run``
on ``tests/conftest.py``'s virtual devices at (2, 2), (4, 1), (1, 4) and
(2, 4); JAX's 'fused' Pallas call does not run under its ``shard_map`` on
the CPU (``ROADMAP.md`` Queue 3), so those cases hold against JAX's
``run_reference_sequential``.  Lags and LTS flags are exact; floats within
1e-4 (the pipeline tolerance) and MdCCM within 1e-5 (the xcorr one).

Then the port runs on 2 and 4 gloo processes (the worker
`parallel.smoke`, launched on a free localhost port with a timeout): rank
0's ``run`` equals the port's ``run_reference_sequential`` (bit for bit
with 'fused' at one band shard; the worker checks it) and is within the
same tolerances of JAX's sharded run.
"""

import logging

import numpy as np
import pytest

from narrow_band_least_squares_tpu.io.synthetic import synthetic_plane_wave
from narrow_band_least_squares_tpu.parallel import ShardedNarrowBandPipeline as JSharded
from narrow_band_least_squares_tpu.parallel import make_mesh as jmesh
from narrow_band_least_squares_tpu.utils.geometry import get_rij
from narrow_band_least_squares_tpu.utils.plan import get_freqlist, get_winlenlist, make_plan
from narrow_band_least_squares_tpu_torch.parallel import ShardedNarrowBandPipeline
from narrow_band_least_squares_tpu_torch.parallel.smoke import WORKLOADS, launch
from narrow_band_least_squares_tpu_torch.utils import plan as tplan

TOL, XTOL = 1e-4, 1e-5
KEYS = ("vel", "baz", "mdccm", "sig_tau", "vel_uncert", "baz_uncert")
SMALL = WORKLOADS["small"]
TIMEOUT_S = 240.0


@pytest.fixture(scope="module")
def long_stream():
    return synthetic_plane_wave(**SMALL["stream"])


def _plans(st):
    freqlist, nbands, _ = get_freqlist(SMALL["fmin"], SMALL["fmax"], "log", SMALL["nbands"])
    winlens = get_winlenlist("adaptive", nbands, *SMALL["winlens"])
    args = (freqlist, "log", winlens, 0.5, int(SMALL["segment_s"] * st.fs), st.fs)
    return make_plan(*args), tplan.make_plan(*args)


def _pair(st, nt, nb, jax_kw=None, **kw):
    """(JAX pipeline on the virtual devices, port pipeline on a virtual
    mesh, segments)."""
    jp, tp = _plans(st)
    rij = get_rij(st.latitudes, st.longitudes, st.nchans)
    j = JSharded(jp, rij, jmesh(nt, nb), filter_type="cheby1", **dict(kw, **(jax_kw or {})))
    t = ShardedNarrowBandPipeline(tp, rij, None, mesh_shape=(nt, nb), filter_type="cheby1",
                                  device="cpu", **kw)
    return j, t, j.segment_stream(st.data)


def _close(got, want, keys=KEYS):
    for k in keys:
        tol = XTOL if k == "mdccm" else TOL
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(want[k]), rtol=tol,
                                   atol=tol, err_msg=k)


CASES = {
    "ols-2x4": ((2, 4), {}),
    "ols-2x2-unequal-slots": ((2, 2), {}),
    "ols-4x1": ((4, 1), {}),
    "ols-1x4": ((1, 4), {}),
    "lts-2x4": ((2, 4), {"alpha": 0.75}),
    "lts-1x4": ((1, 4), {"alpha": 0.75}),
    "band-limit-40db": ((2, 4), {"band_limit_db": 40.0}),
    "band-limit-auto": ((2, 4), {"band_limit_db": "auto"}),
    "max-lag": ((2, 4), {"max_lag_s": 8.0}),
    "funnel": ((2, 4), {"alpha": 0.75, "lts_funnel_k": 8}),
    "global-mxu": ((2, 4), {"bucket_bands": False}),
    "global-band-limit-40db": ((2, 4), {"bucket_bands": False, "band_limit_db": 40.0}),
    "global-band-limit-auto": ((2, 4), {"bucket_bands": False, "band_limit_db": "auto"}),
    "gather": ((2, 2), {"window_method": "gather"}),
    "patches-2x1": ((2, 1), {"window_method": "patches"}),
    "patches-2x2": ((2, 2), {"window_method": "patches"}),
}


@pytest.mark.parametrize("case", list(CASES), ids=list(CASES))
def test_virtual_mesh_matches_jax_sharded_run(long_stream, case):
    (nt, nb), kw = CASES[case]
    j, t, segs = _pair(long_stream, nt, nb, **kw)
    mode = "core" if nb == 1 else ("bucket" if kw.get("bucket_bands", True) else "global")
    assert t._mode == j._mode == mode
    np.testing.assert_array_equal(t._band_perm, j._band_perm)
    want = j.run(segs)
    got = t.run_reference_sequential(segs)
    assert set(got) == set(want)
    _close(got, want)
    if "alpha" in kw:
        np.testing.assert_array_equal(got["flags"], want["flags"])


def test_slot_buckets_match_jax(long_stream):
    """Snake dealing and the slot templates: the same slots, template
    lengths and window counts, per-row lengths and lag half-widths, and
    band-limited tables of the same bins."""
    j, t, _ = _pair(long_stream, 2, 2, band_limit_db="auto")
    assert len(t._slot_buckets) == len(j._slot_buckets)
    for tb, jb, tt, jt in zip(t._slot_buckets, j._slot_buckets, t._bucket_tables,
                              j._bucket_tables):
        np.testing.assert_array_equal(tb["slots"], jb["slots"])
        assert (tb["Wg"], tb["Lg"]) == (jb["Wg"], jb["Lg"])
        np.testing.assert_array_equal(tb["lengths"], np.asarray(jb["lengths"]))
        np.testing.assert_array_equal(tb["lag_half"], np.asarray(jb["lag_half"]))
        np.testing.assert_array_equal(tb["len_mask"], np.asarray(jb["len_mask"]))
        assert tt["Cf"].shape == tuple(jt["Cf"].shape)
        assert tt["lag_min"] == jt["lag_min"]


@pytest.mark.parametrize("method", ["fused", "fft"])
def test_global_mode_fft_matches_jax(long_stream, method):
    """'fused' (and 'fft') under band shards run the FFT cross-correlation
    over the global grid, as JAX's ``"global"`` mode."""
    j, t, segs = _pair(long_stream, 2, 4, xcorr_method=method)
    assert t._mode == j._mode == "global"
    want = j.run(segs) if method == "fft" else j.run_reference_sequential(segs)
    _close(t.run_reference_sequential(segs), want)


def test_fused_time_shards_match_jax(long_stream):
    j, t, segs = _pair(long_stream, 4, 1, xcorr_method="fused",
                       jax_kw=dict(matmul_precision="highest"))
    assert t._mode == "core"
    _close(t.run_reference_sequential(segs), j.run_reference_sequential(segs))


def test_halo_warms_filter_state(long_stream):
    """Counterpart of ``test_sharding.py:101,111``: segment 1 of time shard
    0 and segment 4 (time shard 1's first, whose halo crosses the cut)
    equal JAX's, and the halo is the impulse length."""
    j, t, segs = _pair(long_stream, 2, 4)
    got, want = t.run_reference_sequential(segs), j.run(segs)
    assert t.halo == j.halo > 0 and (t.T_ext, t.nfft_ext) == (j.T_ext, j.nfft_ext)
    for s in (1, 4):
        np.testing.assert_allclose(got["vel"][s], want["vel"][s], rtol=TOL, atol=TOL)
    good = got["mdccm"] > 0.6
    d = np.abs((got["baz"][good] - 310.0 + 180.0) % 360.0 - 180.0)
    assert good.sum() > 0 and np.median(d) < 5.0
    # a cold first segment: without the halo chaining segment 4 would differ
    cold = t.run_reference_sequential(segs[4:6])
    assert not np.allclose(cold["vel"][0], got["vel"][4], atol=1e-3)


def test_band_shards_switch_options_as_jax(long_stream, caplog):
    jp, tp = _plans(long_stream)
    rij = get_rij(long_stream.latitudes, long_stream.longitudes, 4)
    with caplog.at_level(logging.INFO, logger="nbls_torch"):
        p = ShardedNarrowBandPipeline(tp, rij, None, mesh_shape=(1, 2), device="cpu",
                                      xcorr_method="pallas", window_method="patches")
    assert p.base.xcorr_method == "mxu" and p.base.window_method == "strided"
    assert "falling back to 'mxu'" in caplog.text and "using 'strided'" in caplog.text
    with pytest.raises(ValueError, match="not divisible"):
        ShardedNarrowBandPipeline(tp, rij, None, mesh_shape=(1, 3), device="cpu")
    with pytest.raises(ValueError, match="max_lag_s"):
        ShardedNarrowBandPipeline(tp, rij, None, mesh_shape=(1, 2), device="cpu",
                                  xcorr_method="fused", max_lag_s=8.0)
    # at one band shard 'patches' reaches the base pipeline, unbucketed
    p = ShardedNarrowBandPipeline(tp, rij, None, mesh_shape=(2, 1), device="cpu",
                                  window_method="patches")
    assert p.base.window_method == "patches" and not p.base.bucket_bands


def test_rank_holds_only_its_shard(long_stream):
    """A rank's constants are its shard's rows: the view of one band shard
    holds B/nb filter rows and B/nb rows per slot bucket."""
    _, t, _ = _pair(long_stream, 1, 4)
    own = t._view([2])
    full = t._view(range(4))
    assert own["h_bank"].shape[0] * 4 == full["h_bank"].shape[0] == 4
    for ob, fb in zip(own["buckets"], full["buckets"]):
        assert ob["len_mask"].shape[0] * 4 == fb["len_mask"].shape[0]
    np.testing.assert_array_equal(own["h_bank"].numpy(),
                                  full["h_bank"][2 * t.B_loc:3 * t.B_loc].numpy())


def _run_ranks(tmp_path, nproc, *argv):
    out = str(tmp_path / "rank0.npz")
    stats, _ = launch(nproc, [*argv, "--device", "cpu", "--backend", "gloo", "--out", out],
                      timeout_s=TIMEOUT_S, threads=1)
    with np.load(out) as z:
        res = {k: z[k] for k in z.files}
    return stats, {k[4:]: v for k, v in res.items() if k.startswith("out_")}, \
        {k[4:]: v for k, v in res.items() if k.startswith("seq_")}


@pytest.mark.parametrize("nproc,mesh,kw", [
    (4, (4, 1), {"xcorr_method": "fused"}),
    (4, (2, 2), {}),
], ids=["fused-4x1", "mxu-2x2"])
def test_processes_match_sequential_and_jax(long_stream, tmp_path, nproc, mesh, kw):
    """Rank 0's ``run`` on gloo processes: the worker held it to the port's
    ``run_reference_sequential`` (bit for bit with 'fused' at nb == 1,
    within 1e-5 otherwise), every rank returned the whole result, and it is
    within the tolerances of JAX's sharded run (JAX's oracle for 'fused')."""
    argv = ["--mesh-time", str(mesh[0]), "--mesh-band", str(mesh[1])]
    for k, v in kw.items():
        argv += ["--" + k.replace("_", "-"), str(v)]
    stats, out, seq = _run_ranks(tmp_path, nproc, *argv)
    assert [s["rank"] for s in stats] == list(range(nproc))
    assert [(s["t"], s["b"]) for s in stats] == [(r // mesh[1], r % mesh[1])
                                                 for r in range(nproc)]
    # time shards but the last send their halo: C x halo float32 samples
    halo = [s["halo_bytes"] for s in stats]
    assert all((h > 0) == (s["t"] < mesh[0] - 1) for h, s in zip(halo, stats))
    if kw.get("xcorr_method") == "fused":
        assert stats[0]["bit_for_bit_sequential"]
        for k in KEYS:
            np.testing.assert_array_equal(out[k], seq[k], err_msg=k)
    j, _, segs = _pair(long_stream, *mesh, **kw,
                       jax_kw=dict(matmul_precision="highest") if kw else None)
    want = j.run_reference_sequential(segs) if kw else j.run(segs)
    assert out["vel"].shape == (len(segs), j.plan.nbands, j.plan.max_windows)
    _close(out, want)
