"""PyTorch port: MultiArrayPipeline and BroadbandPipeline against the JAX
package, on the CPU (kernels' plain versions).

The fixture is the JAX package's own (``tests/test_multiarray.py:18``): four
4-element arrays with distinct back-azimuths, one shared 2-band plan.
Outputs agree within 1e-5 (rtol and atol), the JAX multi-array tests'
tolerance; the broadband pipeline within the pipeline tolerance of 1e-4.
"""

import numpy as np
import pytest
import torch

from narrow_band_least_squares_tpu.io.synthetic import synthetic_plane_wave
from narrow_band_least_squares_tpu.models.broadband import BroadbandPipeline as JBroad
from narrow_band_least_squares_tpu.models.multiarray import MultiArrayPipeline as JMulti
from narrow_band_least_squares_tpu.utils.geometry import get_rij
from narrow_band_least_squares_tpu.utils.plan import get_freqlist, get_winlenlist, make_plan
from narrow_band_least_squares_tpu_torch.models import (
    BroadbandPipeline,
    MultiArrayPipeline,
    NarrowBandPipeline,
)
from narrow_band_least_squares_tpu_torch.utils import plan as tplan

from test_torch_pipeline import OUTS, _close


@pytest.fixture(scope="module")
def arrays():
    streams = [
        synthetic_plane_wave(
            nchans=4, duration_s=240.0, fs=10.0,
            baz_deg=45.0 + 90.0 * k, trace_vel_kms=0.30 + 0.02 * k,
            f0=0.6, bandwidth=0.8, snr=10.0, seed=100 + k,
        )
        for k in range(4)
    ]
    freqlist, nbands, _ = get_freqlist(0.3, 1.5, "log", 2)
    winlens = get_winlenlist("constant", nbands, 30, 0, 0)
    args = (freqlist, "log", winlens, 0.5, streams[0].npts, streams[0].fs)
    rijs = [get_rij(s.latitudes, s.longitudes, s.nchans) for s in streams]
    data = np.stack([s.data for s in streams])
    return data, make_plan(*args), tplan.make_plan(*args), rijs


def _allclose(got, want, tol=1e-5, keys=("vel", "baz", "mdccm", "sig_tau")):
    for k in keys:
        g = got[k].numpy() if isinstance(got[k], torch.Tensor) else got[k]
        np.testing.assert_allclose(g, np.asarray(want[k]), rtol=tol, atol=tol,
                                   err_msg=k)


METHODS = [
    ("mxu", {}),
    ("fused", {"xcorr_method": "fused"}),
    ("pallas-unbucketed", {"xcorr_method": "pallas", "bucket_bands": False}),
    ("mxu-gather-unbucketed", {"window_method": "gather", "bucket_bands": False}),
]


@pytest.mark.parametrize("kw", [m[1] for m in METHODS], ids=[m[0] for m in METHODS])
def test_batch_matches_jax(arrays, kw):
    data, jp, tp, rijs = arrays
    want = JMulti(jp, rijs, **kw).run_raw(data)
    got = MultiArrayPipeline(tp, rijs, device="cpu", **kw).run_raw(data)
    assert got["vel"].shape == (4, tp.nbands, tp.max_windows)
    _allclose(got, want)


@pytest.mark.parametrize("method", ["mxu", "fused"])
def test_batch_matches_individual(arrays, method):
    data, _, tp, rijs = arrays
    out = MultiArrayPipeline(tp, rijs, xcorr_method=method, device="cpu").run_raw(data)
    for k, rij in enumerate(rijs):
        ref = NarrowBandPipeline(tp, rij, xcorr_method=method, device="cpu").run_raw(data[k])
        _allclose({n: v[k] for n, v in out.items()}, ref)


def test_merge_chunking_parity(arrays):
    """Mirror of ``test_multiarray.py:78``: the default 2-array chunks equal
    the fully merged batch, including a ragged last chunk (A = 3)."""
    data, _, tp, rijs = arrays
    full = MultiArrayPipeline(tp, rijs, merge_chunk_arrays=0, device="cpu")
    assert full.merge_chunk_arrays == 4
    ref = full.run_raw(data)
    out = MultiArrayPipeline(tp, rijs, device="cpu").run_raw(data)
    _allclose(out, ref, keys=OUTS)
    out3 = MultiArrayPipeline(tp, rijs[:3], device="cpu").run_raw(data[:3])
    _allclose(out3, {k: v[:3] for k, v in ref.items()}, keys=OUTS)


@pytest.mark.parametrize("method", ["mxu", "fused"])
def test_batch_recovers_distinct_baz(arrays, method):
    data, _, tp, rijs = arrays
    out = MultiArrayPipeline(tp, rijs, xcorr_method=method, device="cpu").run_raw(data)
    for k in range(4):
        truth = (45.0 + 90.0 * k) % 360.0
        good = out["mdccm"][k].numpy() > 0.6
        baz = out["baz"][k].numpy()[good]
        d = np.abs((baz - truth + 180.0) % 360.0 - 180.0)
        assert np.median(d) < 6.0, f"array {k}"


@pytest.mark.parametrize("case", ["nchans", "mesh", "pallas-bucketed", "count"])
def test_what_is_refused_raises(arrays, case):
    data, _, tp, rijs = arrays
    if case == "nchans":
        with pytest.raises(ValueError, match="same element count"):
            MultiArrayPipeline(tp, rijs[:2] + [np.zeros((2, 6))], device="cpu")
    elif case == "mesh":
        with pytest.raises(TypeError, match="parallel.mesh.Mesh"):
            MultiArrayPipeline(tp, rijs, mesh=object(), device="cpu")
    elif case == "pallas-bucketed":
        pipe = MultiArrayPipeline(tp, rijs, xcorr_method="pallas", device="cpu")
        with pytest.raises(ValueError, match="bucket_bands=False"):
            pipe.run_raw(data)
    else:
        with pytest.raises(ValueError, match="expected 4 arrays"):
            MultiArrayPipeline(tp, rijs, device="cpu").run_raw(data[:3])


def test_multiarray_device_defaults_to_cuda(arrays):
    if torch.cuda.is_available():
        pytest.skip("this box has CUDA: the default device is usable")
    _, _, tp, rijs = arrays
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        MultiArrayPipeline(tp, rijs)


@pytest.mark.parametrize("method", ["mxu", "fused"])
def test_broadband_matches_jax(small_stream, method):
    st = small_stream
    rij = get_rij(st.latitudes, st.longitudes, st.nchans)
    args = (0.3, 1.5, 30.0, 0.5, st.npts, st.fs, rij)
    jb = JBroad(*args, xcorr_method=method, matmul_precision="highest")
    tb = BroadbandPipeline(*args, xcorr_method=method, device="cpu")
    assert tb.plan.nbands == 1
    assert tb.plan.windows[0].starts == jb.plan.windows[0].starts
    _close(tb.run_raw(st.data), jb.run_raw(st.data), OUTS)
    res = tb.run(st)
    assert res.num_compute_list == jb.run(st).num_compute_list
