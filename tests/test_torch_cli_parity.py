"""PyTorch port: its command line against the JAX package's, on the same
inputs (the port with ``--device cpu``, JAX on the CPU).

- ``defaults`` prints the same bytes;
- ``run``: the results TSVs within 1e-4 (rtol and atol, the pipeline
  tolerance), equal ``num_compute_list``, equal ``config_used.json``,
  summary medians within 1e-4;
- ``monitor``: every segment's ``read_all`` arrays within 1e-4, and both
  resume;
- ``fetch`` of the golden fixture through an offline ``urlopen``: the
  ``.npz`` bit for bit the JAX command's, with and without ``--raw``.
"""

import builtins
import contextlib
import io
import json
import os
import subprocess
import sys
import urllib.request

import numpy as np
import pytest

from narrow_band_least_squares_tpu.__main__ import main as jmain
from narrow_band_least_squares_tpu.config import NBLSConfig as JConfig
from narrow_band_least_squares_tpu_torch.__main__ import main as tmain
from narrow_band_least_squares_tpu_torch.config import NBLSConfig

from test_golden_event import _fixture_fetch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-4
CFG = dict(FMIN=0.3, FMAX=2.0, NBANDS=3, WINLEN=40, WINLEN_1=50, WINLEN_X=30)


def _printed(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv)
    return buf.getvalue()


@pytest.fixture(scope="module")
def inputs(tmp_path_factory, small_stream):
    d = tmp_path_factory.mktemp("parity")
    data = str(d / "stream.npz")
    small_stream.save_npz(data)
    cfg = str(d / "cfg.json")
    NBLSConfig(**CFG).to_json(cfg)
    return d, data, cfg


def test_defaults_print_the_same_bytes():
    want = _printed(jmain, ["defaults"])
    assert _printed(tmain, ["defaults"]) == want
    out = subprocess.run([sys.executable, "-m", "narrow_band_least_squares_tpu_torch",
                          "defaults"], cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout == want


def _close(a, b):
    return np.abs(a - b) <= TOL + TOL * np.abs(b)


def _baz_close(a, b):
    return np.abs((a - b + 180.0) % 360.0 - 180.0) <= TOL + TOL * np.abs(b)


def test_run_matches_jax(inputs):
    from narrow_band_least_squares_tpu.io import read_txtfile as jread
    from narrow_band_least_squares_tpu_torch.io import read_txtfile as tread

    d, data, cfg = inputs
    jout, tout = str(d / "run-jax"), str(d / "run-torch")
    js = json.loads(_printed(jmain, ["run", "--data", data, "--config", cfg, "--out", jout,
                                     "--no-figures"]))
    ts = json.loads(_printed(tmain, ["run", "--data", data, "--config", cfg, "--out", tout,
                                     "--no-figures", "--device", "cpu"]))
    assert set(ts) == set(js) and set(ts["phases"]) == set(js["phases"])
    assert ts["num_compute_list"] == js["num_compute_list"]
    assert ts["bands"] == js["bands"] == 3
    t, j = tread(tout, "narrow_band_results"), jread(jout, "narrow_band_results")
    # a window within the tolerance of the threshold may fall either side
    edge = sum(int((np.abs(j[2][b, :n] - 0.6) <= TOL + TOL * 0.6).sum())
               for b, n in enumerate(j[5].astype(int)))
    assert abs(ts["windows_above_threshold"] - js["windows_above_threshold"]) <= edge
    assert ts["median_baz_deg"] == pytest.approx(js["median_baz_deg"], rel=TOL, abs=TOL)
    assert ts["median_vel_kms"] == pytest.approx(js["median_vel_kms"], rel=TOL, abs=TOL)
    np.testing.assert_array_equal(t[5], j[5])        # num_compute_list
    np.testing.assert_array_equal(t[4], j[4])        # freqlist
    assert t[6:] == j[6:]                            # nbands, FMIN, FMAX
    for b, n in enumerate(t[5].astype(int)):
        np.testing.assert_array_equal(t[3][b, :n], j[3][b, :n])   # window times
        assert _close(t[0][b, :n], j[0][b, :n]).all(), f"vel band {b}"
        assert _baz_close(t[1][b, :n], j[1][b, :n]).all(), f"baz band {b}"
        assert _close(t[2][b, :n], j[2][b, :n]).all(), f"mdccm band {b}"
    with open(os.path.join(tout, "config_used.json")) as f, \
            open(os.path.join(jout, "config_used.json")) as g:
        assert json.load(f) == json.load(g)


def test_monitor_matches_jax(inputs):
    from narrow_band_least_squares_tpu.models.streaming import StreamingMonitor as JMon
    from narrow_band_least_squares_tpu_torch.models import StreamingMonitor as TMon
    from narrow_band_least_squares_tpu_torch.utils import (
        get_freqlist, get_rij, get_winlenlist, make_plan,
    )

    d, data, cfg = inputs
    jout, tout = str(d / "mon-jax"), str(d / "mon-torch")
    argv = ["monitor", "--data", data, "--config", cfg, "--segment-s", "120"]
    for main, out, extra in ((jmain, jout, []), (tmain, tout, ["--device", "cpu"])):
        assert json.loads(_printed(main, argv + ["--out", out] + extra)) == {
            "segments_processed": 2, "out_dir": out}
        assert json.loads(_printed(main, argv + ["--out", out] + extra))[
            "segments_processed"] == 0
    c = NBLSConfig(**CFG)
    with np.load(data) as st:
        fs, lats, lons = float(st["fs"]), list(st["latitudes"]), list(st["longitudes"])
    freqlist, nbands, _ = get_freqlist(c.FMIN, c.FMAX, "log", c.NBANDS)
    winlens = get_winlenlist("adaptive", nbands, c.WINLEN, c.WINLEN_1, c.WINLEN_X)
    plan = make_plan(freqlist, "log", winlens, 0.5, int(120 * fs), fs)
    rij = get_rij(lats, lons, len(lats))
    t = TMon(plan, rij, tout, freqlist, device="cpu").read_all(extras=True)
    j = JMon(plan, rij, jout, freqlist).read_all(extras=True)
    np.testing.assert_array_equal(t[4], j[4])
    for b, n in enumerate(t[4]):
        np.testing.assert_array_equal(t[3][b, :n], j[3][b, :n])
        assert _close(t[0][b, :n], j[0][b, :n]).all(), f"vel band {b}"
        assert _baz_close(t[1][b, :n], j[1][b, :n]).all(), f"baz band {b}"
        assert _close(t[2][b, :n], j[2][b, :n]).all(), f"mdccm band {b}"
        for k in ("sig_tau", "vel_uncert", "baz_uncert"):
            assert np.allclose(t[5][k][b, :n], j[5][k][b, :n], rtol=TOL, atol=TOL,
                               equal_nan=True), f"{k} band {b}"


@pytest.fixture
def offline_fixture(monkeypatch):
    """``urllib.request.urlopen`` serving tests/data's golden fixture, and
    ObsPy unimportable, so that both packages take their stdlib FDSN
    client offline."""
    real_import = builtins.__import__

    def no_obspy(name, *a, **k):
        if name.startswith("obspy"):
            raise ImportError("obspy not installed")
        return real_import(name, *a, **k)

    class FakeResp:
        def __init__(self, data):
            self._d = data

        def read(self):
            return self._d

        def __enter__(self):
            return self

        def __exit__(self, *a):
            return False

    def fake_open(req, timeout=0):
        return FakeResp(_fixture_fetch(getattr(req, "full_url", req)))

    monkeypatch.setattr(builtins, "__import__", no_obspy)
    monkeypatch.setattr(urllib.request, "urlopen", fake_open)


@pytest.mark.parametrize("raw", [False, True], ids=["response-removed", "raw"])
def test_fetch_writes_the_jax_npz(raw, tmp_path, offline_fixture):
    cfg = str(tmp_path / "cfg.json")
    JConfig(START="2018-12-19T01:45:00", END="2018-12-19T01:50:00").to_json(cfg)
    flag = ["--raw"] if raw else []
    outs = {}
    for name, main in (("jax", jmain), ("torch", tmain)):
        out = str(tmp_path / f"{name}.npz")
        outs[name] = json.loads(_printed(main, ["fetch", "--config", cfg, "--out", out]
                                         + flag))
        assert outs[name]["out"] == out
    assert {k: v for k, v in outs["torch"].items() if k != "out"} == \
        {k: v for k, v in outs["jax"].items() if k != "out"}
    assert outs["torch"]["nchans"] == 8
    with np.load(tmp_path / "torch.npz") as t, np.load(tmp_path / "jax.npz") as j:
        assert sorted(t.files) == sorted(j.files)
        for k in j.files:
            assert t[k].dtype == j[k].dtype, k
            np.testing.assert_array_equal(t[k], j[k], err_msg=k)
