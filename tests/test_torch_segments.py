"""PyTorch port: the halo-extended segment step
(`parallel.ShardedNarrowBandPipeline` on one device) against the JAX
package's on a mesh of one device, on the CPU (kernels' plain versions).

The stream and plan are ``tests/test_sharding.py``'s ``long_stream`` setup
at one time shard and one band shard: 1600 s of a 4-element array at
10 Hz in eight 200 s segments, 4 log bands over 0.2-1.6 Hz.  Outputs agree
within 1e-4 (rtol and atol), the JAX pipeline tolerance; LTS flags as
``tests/test_torch_lts_pipeline.py`` holds them (`_check`).  The mirrored
JAX tests are named in each docstring.
"""

import numpy as np
import pytest
import torch

from narrow_band_least_squares_tpu.io.synthetic import synthetic_plane_wave
from narrow_band_least_squares_tpu.parallel import ShardedNarrowBandPipeline as JSharded
from narrow_band_least_squares_tpu.parallel import make_mesh
from narrow_band_least_squares_tpu.utils.geometry import get_rij
from narrow_band_least_squares_tpu.utils.plan import get_freqlist, get_winlenlist, make_plan
from narrow_band_least_squares_tpu_torch.models import NarrowBandPipeline
from narrow_band_least_squares_tpu_torch.parallel import ShardedNarrowBandPipeline
from narrow_band_least_squares_tpu_torch.utils import plan as tplan

from test_torch_lts_pipeline import _check, delays  # noqa: F401  (fixture)

TOL = 1e-4
KEYS = ("vel", "baz", "mdccm", "sig_tau")
SEG_S = 200.0


@pytest.fixture(scope="module")
def long_stream():
    return synthetic_plane_wave(
        nchans=4, duration_s=1600.0, fs=10.0, baz_deg=310.0,
        trace_vel_kms=0.32, f0=0.6, bandwidth=0.8, snr=8.0, seed=21,
    )


def _plans(st, seg_s=SEG_S):
    freqlist, nbands, _ = get_freqlist(0.2, 1.6, "log", 4)
    winlens = get_winlenlist("adaptive", nbands, 30, 40, 20)
    args = (freqlist, "log", winlens, 0.5, int(seg_s * st.fs), st.fs)
    return make_plan(*args), tplan.make_plan(*args)


def _build(st, alpha=1.0, jax_kw=None, **kw):
    """(JAX pipeline on a 1x1 mesh, port pipeline on the CPU, segments)."""
    jp, tp = _plans(st)
    rij = get_rij(st.latitudes, st.longitudes, st.nchans)
    jpipe = JSharded(jp, rij, make_mesh(1, 1), filter_type="cheby1", alpha=alpha,
                     **dict(kw, **(jax_kw or {})))
    tpipe = ShardedNarrowBandPipeline(tp, rij, filter_type="cheby1", alpha=alpha,
                                      device="cpu", **kw)
    return jpipe, tpipe, jpipe.segment_stream(st.data)


@pytest.fixture(scope="module")
def ols(long_stream):
    """The OLS pipelines and both packages' `run` on the eight segments."""
    jpipe, tpipe, segs = _build(long_stream)
    return jpipe, tpipe, segs, jpipe.run(segs), tpipe.run(segs)


def _close(got, want, keys=KEYS, tol=TOL):
    for k in keys:
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(want[k]),
                                   rtol=tol, atol=tol, err_msg=k)


@pytest.mark.parametrize("filter_type", ["cheby1", "butter"])
def test_halo_and_fft_sizes_match_jax(long_stream, filter_type):
    """``halo`` is one impulse length (cheby1) or 0 (zero-phase butter),
    ``T_ext = npts + halo`` and ``nfft_ext = next_pow2(T_ext + L)``, as in
    JAX (``sharded.py:205-210``)."""
    st = long_stream
    jp, tp = _plans(st)
    rij = get_rij(st.latitudes, st.longitudes, st.nchans)
    j = JSharded(jp, rij, make_mesh(1, 1), filter_type=filter_type)
    t = ShardedNarrowBandPipeline(tp, rij, filter_type=filter_type, device="cpu")
    assert (t.halo, t.T_ext, t.nfft_ext) == (j.halo, j.T_ext, j.nfft_ext)
    assert (t.halo > 0) == (filter_type == "cheby1")


OFFSETS = {"first": [0], "contiguous": [0, 2000, 4000],
           "non-contiguous": [6000, 2000, 12000]}


@pytest.mark.parametrize("offsets", list(OFFSETS.values()), ids=list(OFFSETS))
def test_extend_segments_matches_jax(long_stream, offsets):
    """Halos from the raw stream, zeros before sample 0, at any offsets;
    with the bfloat16 wire the samples the device receives equal JAX's
    ``ml_dtypes`` rounding bit for bit."""
    st = long_stream
    jpipe, tpipe, _ = _build(st)
    got = tpipe.extend_segments(st.data, offsets)
    want = jpipe.extend_segments(st.data, offsets)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)

    jb, tb, _ = _build(st, transfer_dtype="bfloat16")
    assert tb.transfer_dtype == torch.bfloat16 and tb.transfer_dtype.itemsize == 2
    host, dev = tb._to_wire(tb.extend_segments(st.data, offsets))
    assert host.dtype == dev.dtype == torch.bfloat16
    want = jb.extend_segments(st.data, offsets)
    assert want.dtype.itemsize == 2
    np.testing.assert_array_equal(dev.float().numpy(), want.astype(np.float32))


def test_run_ols_matches_jax(ols):
    """Counterpart of ``test_sharding.py:67`` (OLS, run against the
    sequential path) on one device: the port's ``run`` of the eight
    segments against JAX's."""
    jpipe, tpipe, segs, want, got = ols
    S, B, W = len(segs), tpipe.plan.nbands, tpipe.plan.max_windows
    assert got["vel"].shape == (S, B, W) and "flags" not in got
    _close(got, want, keys=tpipe._PACK_KEYS)


def test_run_fused_matches_jax(long_stream):
    """'fused' (one ``fused_xcorr_bucket`` launch per bucket for the whole
    batch) against JAX's fused kernel at 'highest', on four segments.  JAX's
    Pallas call does not run under its ``shard_map`` on the CPU, so the
    reference is its single-device oracle, ``run_reference_sequential``
    (the same halo chaining, without the mesh)."""
    jpipe, tpipe, segs = _build(long_stream, xcorr_method="fused",
                                jax_kw=dict(matmul_precision="highest"))
    _close(tpipe.run(segs[:4]), jpipe.run_reference_sequential(segs[:4]))


def test_run_lts_matches_jax(long_stream, delays):  # noqa: F811
    """Counterpart of ``test_sharding.py:77`` (LTS, ``alpha = 0.75``): vel
    within 1e-4 and the flags of each segment as
    ``test_torch_lts_pipeline._check`` holds them, on the delays each
    package's solve received."""
    jpipe, tpipe, segs = _build(long_stream, alpha=0.75)
    want = jpipe.run(segs)
    got = tpipe.run(segs)
    P = len(tpipe.base.pairs_np)
    assert got["flags"].shape == (len(segs), tpipe.plan.nbands,
                                  tpipe.plan.max_windows, P)
    np.testing.assert_allclose(got["vel"], want["vel"], rtol=TOL, atol=TOL)
    for s in range(len(segs)):
        _check(tpipe.base, {k: torch.as_tensor(v[s]) for k, v in got.items()},
               {k: v[s] for k, v in want.items()}, delays, run=s)


def test_run_equals_reference_sequential(ols):
    """Counterpart of ``test_sharding.py:67,146``: the batched ``run``
    equals the segment-by-segment oracle (merged delay batches may round
    the forward-DFT matmul differently, hence 1e-5)."""
    _, tpipe, segs, _, got = ols
    seq = tpipe.run_reference_sequential(segs)
    _close(got, seq, keys=tpipe._PACK_KEYS, tol=1e-5)


def test_halo_warms_filter_state(ols):
    """Counterpart of ``test_sharding.py:101,111``: segment 1 (warm halo)
    equals JAX's sequential oracle, and the direction is recovered."""
    jpipe, tpipe, segs, _, got = ols
    seq = jpipe.run_reference_sequential(segs)
    np.testing.assert_allclose(got["vel"][1], seq["vel"][1], rtol=TOL, atol=TOL)
    assert tpipe.halo > 0
    good = got["mdccm"] > 0.6
    assert good.sum() > 0
    d = np.abs((got["baz"][good] - 310.0 + 180.0) % 360.0 - 180.0)
    assert np.median(d) < 5.0


def test_cold_segment_matches_single_chip_pipeline(ols):
    """Counterpart of ``test_sharding.py:156``: segment 0 (zero halo, the
    cold start) against the port's `NarrowBandPipeline.run_raw` of the same
    raw segment, within the JAX test's cross-FFT-size tolerances."""
    _, tpipe, segs, _, got = ols
    base = NarrowBandPipeline(tpipe.plan, tpipe.base.rij, filter_type="cheby1",
                              device="cpu")
    ref = {k: v.numpy() for k, v in base.run_raw(segs[0]).items()}
    good = ref["mdccm"] > 0.5
    assert good.sum() > 0
    np.testing.assert_allclose(got["vel"][0][good], ref["vel"][good], rtol=1e-3,
                               atol=1e-3)
    np.testing.assert_allclose(got["baz"][0][good], ref["baz"][good], rtol=1e-3,
                               atol=1e-2)


@pytest.mark.parametrize("alpha", [1.0, 0.75], ids=["ols", "lts"])
def test_async_returns_device_tensors(long_stream, alpha):
    """``run_extended_async`` leaves its outputs on the pipeline's device
    (packed, plus the LTS flags) with the wire buffer beside them;
    ``finalize_extended`` returns numpy keyed as JAX's."""
    st = long_stream
    jpipe, tpipe, _ = _build(st, alpha=alpha)
    x_ext = tpipe.extend_segments(st.data, [0, 2000])
    dev = tpipe.run_extended_async(x_ext)
    assert dev["packed"].device == tpipe.device
    assert dev["packed"].shape == (6, 2, tpipe.plan.nbands, tpipe.plan.max_windows)
    assert dev["wire"].device.type == "cpu"
    assert ("flags" in dev) == (alpha < 1.0)
    if alpha < 1.0:
        assert dev["flags"].device == tpipe.device and dev["flags"].dtype == torch.bool
    got = tpipe.finalize_extended(dev)
    want = jpipe.finalize_extended(jpipe.run_extended_async(x_ext))
    assert set(got) == set(want)
    assert all(isinstance(v, np.ndarray) for v in got.values())
    assert got["vel"].dtype == np.float32
    np.testing.assert_allclose(got["vel"], want["vel"], rtol=TOL, atol=TOL)


@pytest.mark.parametrize("mesh,mesh_shape", [(object(), None), (None, (2, 1)),
                                             (None, (1, 4))],
                         ids=["mesh", "time-shards", "band-shards"])
def test_mesh_other_than_one_device_raises(long_stream, mesh, mesh_shape):
    """A mesh that is not a `parallel.mesh.Mesh` raises; a ``mesh_shape``
    without a mesh is a virtual mesh, whose ``run`` raises (as the JAX
    package's ``_require_mesh``) while its oracle runs."""
    _, tp = _plans(long_stream)
    rij = get_rij(long_stream.latitudes, long_stream.longitudes, 4)
    if mesh is not None:
        with pytest.raises(TypeError, match="parallel.mesh.Mesh"):
            ShardedNarrowBandPipeline(tp, rij, mesh, mesh_shape=mesh_shape, device="cpu")
        return
    virt = ShardedNarrowBandPipeline(tp, rij, None, mesh_shape=mesh_shape, device="cpu")
    segs = virt.segment_stream(long_stream.data)
    with pytest.raises(RuntimeError, match="virtual mesh"):
        virt.run(segs)
    assert virt.run_reference_sequential(segs[:2 * mesh_shape[0]])["vel"].shape == (
        2 * mesh_shape[0], tp.nbands, tp.max_windows)
    one = ShardedNarrowBandPipeline(tp, rij, None, mesh_shape=(1, 1), device="cpu")
    assert one.segment_stream(long_stream.data).shape == (8, 4, tp.npts)
