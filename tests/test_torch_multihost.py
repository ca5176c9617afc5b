"""PyTorch port: several processes on ``torch.distributed`` (gloo, CPU).

Mirrors ``tests/test_multihost.py`` and ``tests/test_streaming.py:92-107``.
Each test launches the port's worker (`parallel.smoke`, one process per
rank, at most 4, on a free localhost port, with a timeout; every rank's
exit code is checked) on the ``small`` workload: 1600 s of a 4-element
array at 10 Hz in 200 s segments, 4 log bands over 0.2-1.6 Hz.

- two processes on a (time=2) mesh: the halo crosses the process boundary;
  rank 0's result against the port's oracle (in the worker) and JAX's
  sharded run on ``tests/conftest.py``'s virtual devices;
- the monitor on 4 processes (time=4): only rank 0 writes, a second pass
  does nothing, a deleted segment is redone alone; the persisted results
  against the one-process monitor;
- the monitor on a 2x2 mesh against the one-process monitor;
- LTS (``alpha = 0.75``) on a (2, 2) mesh: flags equal to the oracle's (in
  the worker) and to JAX's sharded run;
- `MultiArrayPipeline(mesh=)` on (time=2): each rank merges its two arrays;
  against single-array runs (in the worker) and JAX's on its mesh.

Floats within 1e-4 (the pipeline tolerance), MdCCM within 1e-5; between
two port runs that differ only in batch shapes, 1e-5.
"""

import os

import numpy as np
import pytest

from narrow_band_least_squares_tpu.io.synthetic import synthetic_plane_wave
from narrow_band_least_squares_tpu.models.multiarray import MultiArrayPipeline as JMulti
from narrow_band_least_squares_tpu.parallel import ShardedNarrowBandPipeline as JSharded
from narrow_band_least_squares_tpu.parallel import make_mesh as jmesh
from narrow_band_least_squares_tpu.utils.geometry import get_rij
from narrow_band_least_squares_tpu.utils.plan import get_freqlist, get_winlenlist, make_plan
from narrow_band_least_squares_tpu_torch.models import StreamingMonitor
from narrow_band_least_squares_tpu_torch.parallel.smoke import (
    WORKLOADS,
    launch,
    multiarray_inputs,
)
from narrow_band_least_squares_tpu_torch.utils import plan as tplan

TOL, XTOL = 1e-4, 1e-5
SMALL = WORKLOADS["small"]
TIMEOUT_S = 240.0


def _ranks(tmp_path, nproc, *argv):
    out = str(tmp_path / "rank0.npz")
    stats, outs = launch(nproc, [*argv, "--device", "cpu", "--backend", "gloo",
                                 "--out", out], timeout_s=TIMEOUT_S, threads=1)
    assert len(stats) == nproc and all("NBLS_SMOKE_OK" in o for o in outs)
    with np.load(out) as z:
        return stats, {k: z[k] for k in z.files}


def _jax_pipe(nt, nb, **kw):
    st = synthetic_plane_wave(**SMALL["stream"])
    freqlist, nbands, _ = get_freqlist(SMALL["fmin"], SMALL["fmax"], "log", SMALL["nbands"])
    winlens = get_winlenlist("adaptive", nbands, *SMALL["winlens"])
    plan = make_plan(freqlist, "log", winlens, 0.5, int(SMALL["segment_s"] * st.fs), st.fs)
    rij = get_rij(st.latitudes, st.longitudes, st.nchans)
    pipe = JSharded(plan, rij, jmesh(nt, nb), filter_type="cheby1", **kw)
    return pipe, pipe.segment_stream(st.data)


def _close(res, want, prefix="out_"):
    for k in ("vel", "baz", "mdccm", "sig_tau", "vel_uncert", "baz_uncert"):
        tol = XTOL if k == "mdccm" else TOL
        np.testing.assert_allclose(res[prefix + k], np.asarray(want[k]), rtol=tol,
                                   atol=tol, err_msg=k)


def test_two_process_distributed_smoke(tmp_path):
    stats, res = _ranks(tmp_path, 2)
    assert [(s["rank"], s["t"], s["b"]) for s in stats] == [(0, 0, 0), (1, 1, 0)]
    assert all(s["backend"] == "gloo" and s["mode"] == "core" for s in stats)
    # rank 0 sends its last segment's tail (4 channels x halo float32) and
    # receives nothing; rank 1 the reverse
    jpipe, segs = _jax_pipe(2, 1)
    assert stats[0]["halo_bytes"] == 4 * jpipe.halo * 4 and stats[1]["halo_bytes"] == 0
    assert stats[0]["bit_for_bit_sequential"]
    assert res["out_vel"].shape == (len(segs), 4, jpipe.plan.max_windows)
    _close(res, jpipe.run(segs))


def _one_process_monitor(save_dir):
    from narrow_band_least_squares_tpu_torch.parallel.smoke import inputs

    st, plan, rij, freqlist = inputs("small")
    mon = StreamingMonitor(plan, rij, str(save_dir), freqlist, device="cpu")
    assert len(mon.process(st)) == len(mon.segment_starts(st))
    return mon.read_all()


@pytest.mark.parametrize("mesh", [(4, 1), (2, 2)], ids=["4x1", "2x2"])
def test_four_process_monitor_persist_resume(tmp_path, mesh):
    """Rank 0 alone persists; the resume mask is rank 0's, broadcast; a
    deleted segment is redone alone (the worker checks all three), and the
    persisted results equal the one-process monitor's within 1e-5."""
    d = tmp_path / "mon"
    d.mkdir()
    stats, res = _ranks(tmp_path, 4, "--mesh-time", str(mesh[0]), "--mesh-band",
                        str(mesh[1]), "--monitor-dir", str(d))
    assert all(s["batch"] == 4 for s in stats)
    assert all(s["broadcast_bytes"] > 0 for s in stats)
    names = sorted(os.listdir(d))
    assert len([n for n in names if n.endswith(".txt")]) == 8
    assert len([n for n in names if n.endswith(".npz")]) == 8
    vel, baz, mdccm, t, num = _one_process_monitor(tmp_path / "one")
    np.testing.assert_array_equal(res["mon_num"], num)
    np.testing.assert_array_equal(res["mon_t"], t)
    for got, want in ((res["mon_vel"], vel), (res["mon_baz"], baz),
                      (res["mon_mdccm"], mdccm)):
        np.testing.assert_allclose(got, want, rtol=XTOL, atol=XTOL)


def test_four_process_2x2_mesh_lts(tmp_path):
    """LTS on (time=2, band=2): the halo and the band shards' rows cross
    process boundaries; the flags equal the oracle's on every window (the
    worker holds them on windows with bit-identical delays, all of them
    here) and JAX's sharded run's."""
    stats, res = _ranks(tmp_path, 4, "--mesh-time", "2", "--mesh-band", "2",
                        "--alpha", "0.75")
    assert stats[0]["lts_same_delay_share"] == 1.0
    assert all(s["mode"] == "bucket" for s in stats)
    np.testing.assert_array_equal(res["out_flags"], res["seq_flags"])
    jpipe, segs = _jax_pipe(2, 2, alpha=0.75)
    want = jpipe.run(segs)
    _close(res, want)
    np.testing.assert_array_equal(res["out_flags"], np.asarray(want["flags"]))


@pytest.mark.parametrize("method", ["mxu", "fused"])
def test_multiarray_on_a_mesh(tmp_path, method):
    """Four arrays on (time=2): each rank merges its two into one delay
    batch; every array within 1e-5 of its single-array run (the worker) and
    within the pipeline tolerance of JAX's ``MultiArrayPipeline(mesh=)``."""
    stats, res = _ranks(tmp_path, 2, "--multiarray", "--xcorr-method", method)
    assert [s["local_arrays"] for s in stats] == [2, 2]
    plan_t, rijs, data, _ = multiarray_inputs("small")
    jplan = make_plan(*_plan_args(plan_t))
    kw = {"matmul_precision": "highest"} if method == "fused" else {}
    want = JMulti(jplan, rijs, mesh=jmesh(2, 1), xcorr_method=method, **kw).run_raw(data)
    _close(res, want, prefix="multi_")


def _plan_args(plan):
    """multiarray_inputs' plan arguments, for the JAX package's make_plan."""
    freqlist, nbands, _ = get_freqlist(0.3, 1.5, "log", 2)
    winlens = get_winlenlist("constant", nbands, 30, 0, 0)
    assert tplan.make_plan(freqlist, "log", winlens, 0.5, plan.npts, plan.fs).windows \
        == plan.windows
    return freqlist, "log", winlens, 0.5, plan.npts, plan.fs
