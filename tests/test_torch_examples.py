"""PyTorch port: the example drivers (`narrow_band_least_squares_tpu_torch.
examples`) run end to end with ``--cpu`` at a reduced size (their module
constants patched: 4 elements at 10 Hz, 3 bands over 0.2-1.6 Hz, minutes
instead of hours), write their outputs where they are told, find the
synthetic source, and the monitor examples resume.
"""

import os

import numpy as np
import pytest

from narrow_band_least_squares_tpu_torch.examples import (
    device_from_argv,
    example,
    example_monitoring,
    example_parallel,
    example_streaming_ingest,
)

SMALL = dict(NCHANS=4, FS=10.0, FMIN=0.2, FMAX=1.6, NBANDS=3, WINLEN=30, WINLEN_1=40,
             WINLEN_X=20)


def _patch(monkeypatch, mod, **kw):
    for k, v in {**SMALL, **kw}.items():
        assert hasattr(mod, k), k
        monkeypatch.setattr(mod, k, v)


def _baz_ok(baz, true=230.0, tol=5.0):
    return abs((float(np.median(baz)) - true + 180.0) % 360.0 - 180.0) < tol


def test_device_switch():
    assert device_from_argv([]) == "cuda"
    assert device_from_argv(["--cpu"]) == "cpu"


@pytest.mark.parametrize("alpha", [1.0, 0.75], ids=["ols", "lts"])
def test_example(alpha, monkeypatch, tmp_path):
    _patch(monkeypatch, example, END_OFFSET_S=240, dpi_num=20, ALPHA=alpha,
           FIG_DIR=str(tmp_path))
    num, mdccm, baz, vel = example.main(["--cpu"])
    names = ["Broadband_Least_Squares", "Filter_Frequency_Response_Broadband",
             "Narrow_Band_Least_Squares", "Narrow_Band_Processing_Parameters"]
    names += (["Narrow_Band_Least_Squares_Sigma_Tau"] if alpha == 1.0 else
              ["Narrow_Band_Least_Squares_LTS",
               "Narrow_Band_Least_Squares_LTS_Dropped_Stations"])
    assert sorted(os.listdir(tmp_path)) == sorted(n + ".png" for n in names)
    good = np.concatenate([mdccm[b, :n] > 0.6 for b, n in enumerate(num)])
    assert good.sum() > 10
    assert _baz_ok(np.concatenate([baz[b, :n] for b, n in enumerate(num)])[good])


def test_example_monitoring(monkeypatch, tmp_path):
    _patch(monkeypatch, example_monitoring, HOURS=0.2, SEGMENT_S=240.0, dpi_num=20,
           SAVE_DIR=str(tmp_path / "mon"), FIG_DIR=str(tmp_path / "fig"))
    recs, baz = example_monitoring.main(["--cpu"])
    assert len(recs) == 3 and len(baz) > 10 and _baz_ok(baz)
    assert sorted(os.listdir(tmp_path / "fig")) == [
        "Monitoring_Backazimuth_vs_Frequency.png", "Monitoring_Uncertainty_vs_Frequency.png"]
    recs2, baz2 = example_monitoring.main(["--cpu"])   # resume: nothing new
    assert recs2 == [] and np.array_equal(baz2, baz)


def test_example_streaming_ingest(monkeypatch, tmp_path):
    _patch(monkeypatch, example_streaming_ingest, DURATION_S=720.0, SEGMENT_S=240.0,
           RECORD_SAMPLES=200, SAVE_DIR=str(tmp_path))
    done, baz = example_streaming_ingest.main(["--cpu"])
    assert done == 3 and len(baz) > 10 and _baz_ok(baz)
    assert len([n for n in os.listdir(tmp_path) if n.endswith(".txt")]) == 3


def test_example_parallel_one_process(monkeypatch, capsys):
    """One process, no process group: the 1x1 mesh from
    ``auto_mesh_shape(1, NBANDS)``; the stream covers one segment per time
    shard at least."""
    _patch(monkeypatch, example_parallel, HOURS=0.2, SEGMENT_S=240.0)
    out, good = example_parallel.main(["--cpu"])
    text = capsys.readouterr().out
    assert "processes=1 mesh=(time=1, band=1)" in text and "segments=3" in text
    assert out["vel"].shape[:2] == (3, 3)
    assert good.sum() > 10 and _baz_ok(out["baz"][good])
