"""PyTorch port: ``api.ltsva``'s convenience plot is best-effort, as the
reference's is (``narrow_band_least_squares_tpu/api.py:224-236``): a plot
that cannot be drawn or saved still returns the 8-tuple, equal to the run
without the plot."""

import os
import sys

import numpy as np
import pytest

from narrow_band_least_squares_tpu_torch import api as tapi

from test_torch_pipeline import _tstream


@pytest.mark.parametrize("fault", ["none", "savefig-raises", "no-matplotlib"])
def test_ltsva_plot_is_best_effort(small_stream, tmp_path, monkeypatch, fault):
    st = small_stream
    args = (_tstream(st), st.latitudes, st.longitudes, 30.0, 0.5, 1.0)
    want = tapi.ltsva(*args, device="cpu")
    monkeypatch.chdir(tmp_path)
    if fault == "savefig-raises":
        import matplotlib.figure

        def refuse(self, *a, **k):
            raise OSError("read-only file system")

        monkeypatch.setattr(matplotlib.figure.Figure, "savefig", refuse)
    elif fault == "no-matplotlib":
        monkeypatch.setitem(sys.modules, "matplotlib.pyplot", None)
    got = tapi.ltsva(*args, plot_array_coordinates=True, device="cpu")
    assert len(got) == 8
    for g, w in zip(got, want):
        if w is None:
            assert g is None
        else:
            np.testing.assert_array_equal(g, w)
    assert os.path.exists("array_coordinates.png") == (fault == "none")
