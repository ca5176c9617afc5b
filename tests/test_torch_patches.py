"""PyTorch port: ``window_method='patches'`` (`ops.windows.
extract_windows_patches`, ``Tensor.unfold`` over the band rows padded by
Lmax) against the JAX package's im2col extractor
(``conv_general_dilated_patches``) and its pipelines, on the CPU.

The windows equal the port's strided windows bit for bit on every slot (a
patch copies samples) and JAX's within 1e-6 (the demeaning sums in
another order: measured at most 2.4e-7).  The JAX package turns bucketing off for 'patches'
(``models/narrowband.py:331-335``), and so does the port: the pipelines
agree with JAX's within 1e-4 and equal the port's unbucketed 'gather' run
bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from narrow_band_least_squares_tpu.models.multiarray import MultiArrayPipeline as JMulti
from narrow_band_least_squares_tpu.models.narrowband import NarrowBandPipeline as JPipe
from narrow_band_least_squares_tpu.ops import windows as JW
from narrow_band_least_squares_tpu.utils.geometry import get_rij
from narrow_band_least_squares_tpu_torch.models import MultiArrayPipeline, NarrowBandPipeline
from narrow_band_least_squares_tpu_torch.ops import windows as TW

from test_torch_multiarray import arrays  # noqa: F401  (fixture)
from test_torch_pipeline import OUTS, _close, _plans


@pytest.mark.parametrize("kind", ["constant", "adaptive"])
def test_patches_equal_jax_and_strided(small_stream, kind):
    st = small_stream
    jp, tp = _plans(st, 4, kind)
    grid = JW.build_window_grid(jp)
    rng = np.random.default_rng(3)
    y = rng.standard_normal((jp.nbands, st.nchans, st.npts)).astype(np.float32)
    want = np.asarray(JW.extract_windows_patches(
        jnp.asarray(y), jp, jnp.asarray(grid.len_mask, jnp.float32),
        jnp.asarray(grid.lengths, jnp.float32)))
    tgrid = TW.build_window_grid(tp)
    lm = torch.as_tensor(tgrid.len_mask, dtype=torch.float32)
    lengths = torch.as_tensor(tgrid.lengths, dtype=torch.float32)
    got = TW.extract_windows_patches(torch.from_numpy(y), tp, lm, lengths)
    assert got.shape == want.shape == (tp.nbands, tp.max_windows, st.nchans, tp.max_winlensamp)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    strided = TW.extract_windows_strided(torch.from_numpy(y), tp, lm, lengths)
    assert torch.equal(got, strided)


CASES = [
    ("mxu", {}),
    ("mxu-maxlag", {"max_lag_s": 1.5}),
    ("pallas", {"xcorr_method": "pallas"}),
    ("lts", {"alpha": 0.75}),
    ("subsample", {"subsample_delays": True}),
]


@pytest.mark.parametrize("kw", [c[1] for c in CASES], ids=[c[0] for c in CASES])
def test_pipeline_patches_matches_jax(small_stream, kw):
    st = small_stream
    jp, tp = _plans(st, 4, "adaptive")
    rij = get_rij(st.latitudes, st.longitudes, st.nchans)
    jpipe = JPipe(jp, rij, window_method="patches", **kw)
    pipe = NarrowBandPipeline(tp, rij, window_method="patches", device="cpu", **kw)
    assert not pipe.bucket_bands and not jpipe.bucket_bands
    got = pipe.run_raw(st.data)
    _close(got, jpipe.run_raw(st.data), OUTS)
    ref = NarrowBandPipeline(tp, rij, window_method="gather", bucket_bands=False,
                             device="cpu", **kw).run_raw(st.data)
    for k in ref:
        assert torch.equal(got[k], ref[k]), k


def test_multiarray_patches_matches_jax(arrays):  # noqa: F811
    data, jp, tp, rijs = arrays
    want = JMulti(jp, rijs, window_method="patches").run_raw(data)
    got = MultiArrayPipeline(tp, rijs, window_method="patches", device="cpu").run_raw(data)
    for k in ("vel", "baz", "mdccm", "sig_tau"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-5,
                                   atol=1e-5, err_msg=k)
