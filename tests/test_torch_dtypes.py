"""PyTorch port: pipeline dtypes other than float32, by what the JAX package
does with them (`models.narrowband.check_dtype`), on the CPU.

- float64 warns and computes float32 (the JAX package never enables x64:
  every output is float32 and equals the float32 run);
- bfloat16 and float16 run with ``apply_filter=False`` and 'mxu' or
  'pallas' (``ltsva``'s contract), outputs in that dtype and MdCCM in
  float32, and raise ``ValueError`` with the filter bank, 'fused' or 'fft'
  (the JAX package fails there).

Against the JAX package the narrow dtypes agree only within their own
rounding: XLA keeps a fused chain of operations in float32 and rounds where
the fusion ends, the port rounds after each operation, and LTS picks among
the many exact ties of narrow residuals.  Measured on the outlier stream
(6 elements, one incoherent), ``ltsva`` with 30 s windows, 15 windows:

- OLS: bfloat16 vel equal on every window, baz within 0.5 deg (one bf16
  step above 128), MdCCM within 2.9e-3 (the windows' bf16 energies, summed
  in another order); float16 vel within 1.2e-3 of itself, baz within
  0.0625 deg, MdCCM within 3.1e-6;
- LTS: flags equal on 14 of 15 windows in bfloat16 and 11 of 15 in
  float16; on those, vel and baz as with OLS.

The tolerances hold those with room: vel 5e-3 relative and baz 1 deg on
windows whose flags agree, MdCCM 5e-3 (bf16) and 1e-4 (fp16) on all, flags
equal on at least 10 of 15 windows.
"""

import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from narrow_band_least_squares_tpu import api as japi
from narrow_band_least_squares_tpu.oracle.ltsva import filter_and_taper
from narrow_band_least_squares_tpu.utils.geometry import get_rij
from narrow_band_least_squares_tpu_torch import api as tapi
from narrow_band_least_squares_tpu_torch.models import (
    MultiArrayPipeline,
    NarrowBandPipeline,
)
from narrow_band_least_squares_tpu_torch.parallel import ShardedNarrowBandPipeline

from test_torch_pipeline import _plans, _tstream

NARROW = {"bfloat16": (torch.bfloat16, jnp.bfloat16, 5e-3),
          "float16": (torch.float16, jnp.float16, 1e-4)}
VEL_RTOL, BAZ_DEG, FLAGS_MIN = 5e-3, 1.0, 10 / 15


@pytest.fixture(scope="module")
def filtered(outlier_stream):
    st = outlier_stream
    stf = st.copy()
    stf.data, _ = filter_and_taper(st.data, st.fs, "cheby1", 0.2, 1.2, 2, 0.01)
    return stf


def test_float64_computes_float32(small_stream, caplog):
    st = small_stream
    _, tp = _plans(st, 2, "constant")
    rij = get_rij(st.latitudes, st.longitudes, st.nchans)
    with caplog.at_level(logging.WARNING, logger="nbls_torch"):
        pipe = NarrowBandPipeline(tp, rij, dtype=torch.float64, device="cpu")
    assert "computes float32" in caplog.text and pipe.dtype == torch.float32
    got = pipe.run_raw(st.data)
    ref = NarrowBandPipeline(tp, rij, device="cpu").run_raw(st.data)
    for k in ref:
        assert got[k].dtype == ref[k].dtype and torch.equal(got[k], ref[k]), k
    multi = MultiArrayPipeline(tp, [rij, rij], dtype=torch.float64, device="cpu")
    out = multi.run_raw(np.stack([st.data, st.data]))
    assert torch.equal(out["vel"][1], ref["vel"])


@pytest.mark.parametrize("name", list(NARROW))
@pytest.mark.parametrize("method", ["mxu", "pallas"])
@pytest.mark.parametrize("alpha", [1.0, 0.75])
def test_narrow_ltsva_matches_jax(filtered, name, method, alpha):
    tdt, jdt, md_tol = NARROW[name]
    st = filtered
    japi.set_performance_defaults(dtype=jdt, xcorr_method=method)
    tapi.set_performance_defaults(dtype=tdt, xcorr_method=method)
    try:
        want = japi.ltsva(st, st.latitudes, st.longitudes, 30.0, 0.5, alpha)
        got = tapi.ltsva(_tstream(st), st.latitudes, st.longitudes, 30.0, 0.5, alpha,
                         device="cpu")
        pipe = tapi._get_pipeline(tapi.make_plan([0.0, st.fs / 2], "linear", [30.0], 0.5,
                                                 st.npts, st.fs),
                                  get_rij(st.latitudes, st.longitudes, st.nchans),
                                  alpha=alpha, apply_filter=False, device="cpu")
        raw = pipe.run_raw(st.data)
    finally:
        japi.set_performance_defaults(dtype=None, xcorr_method=None)
        tapi.set_performance_defaults(dtype=None, xcorr_method=None)
    assert raw["vel"].dtype == tdt and raw["sig_tau"].dtype == tdt
    assert raw["mdccm"].dtype == torch.float32
    vel, baz, md = got[0], got[1], got[3]
    agree = np.ones(len(vel), dtype=bool)
    if alpha < 1.0:
        keys = [k for k in want[4] if k != "size"]
        assert keys == [k for k in got[4] if k != "size"]
        agree = np.array([np.array_equal(np.asarray(want[4][k]), np.asarray(got[4][k]))
                          for k in keys])
        assert agree.mean() >= FLAGS_MIN
    d = np.abs((baz - want[1] + 180.0) % 360.0 - 180.0)
    np.testing.assert_allclose(vel[agree], want[0][agree], rtol=VEL_RTOL, atol=0)
    assert d[agree].max() <= BAZ_DEG
    np.testing.assert_allclose(md, want[3], atol=md_tol, rtol=0)


@pytest.mark.parametrize("name", list(NARROW))
def test_narrow_dtypes_refused_where_jax_fails(small_stream, name):
    tdt = NARROW[name][0]
    st = small_stream
    _, tp = _plans(st, 2, "constant")
    rij = get_rij(st.latitudes, st.longitudes, st.nchans)
    with pytest.raises(ValueError, match="RFFT input must be float32"):
        NarrowBandPipeline(tp, rij, dtype=tdt, device="cpu")
    with pytest.raises(ValueError, match="Invalid dtype for swap"):
        NarrowBandPipeline(tp, rij, dtype=tdt, apply_filter=False, xcorr_method="fused",
                           device="cpu")
    with pytest.raises(ValueError, match="RFFT input must be float32"):
        NarrowBandPipeline(tp, rij, dtype=tdt, apply_filter=False, xcorr_method="fft",
                           device="cpu")
    with pytest.raises(ValueError, match="RFFT input must be float32"):
        ShardedNarrowBandPipeline(tp, rij, None, mesh_shape=(1, 1), dtype=tdt,
                                  device="cpu")
    with pytest.raises(ValueError, match="unsupported dtype"):
        NarrowBandPipeline(tp, rij, dtype=torch.int32, device="cpu")


def test_narrow_multiarray_equals_single(small_stream):
    """bfloat16 through `MultiArrayPipeline` (merged windows) equals the
    single-array runs."""
    st = small_stream
    _, tp = _plans(st, 2, "constant")
    rij = get_rij(st.latitudes, st.longitudes, st.nchans)
    kw = dict(dtype=torch.bfloat16, apply_filter=False, device="cpu")
    data = np.stack([st.data, st.data[::-1].copy()])
    out = MultiArrayPipeline(tp, [rij, rij[:, ::-1].copy()], **kw).run_raw(data)
    for a, r in enumerate([rij, rij[:, ::-1].copy()]):
        one = NarrowBandPipeline(tp, r, **kw).run_raw(data[a])
        for k in ("vel", "baz", "mdccm"):
            torch.testing.assert_close(out[k][a], one[k], rtol=1e-5, atol=1e-5)
