"""PyTorch port: the command line, as ``tests/test_cli.py`` holds the JAX
package's, with ``--device cpu``.

defaults, run (with and without figures), monitor with resume, the
Nyquist error, miniSEED input, pipeline options from a config file
('patches', once refused, writes the default config's results).
``tests/test_torch_cli_parity.py`` holds the
port's commands against the JAX package's on the same inputs.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from narrow_band_least_squares_tpu_torch.__main__ import main
from narrow_band_least_squares_tpu_torch.config import NBLSConfig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIGURES = ("Broadband_Least_Squares", "Narrow_Band_Least_Squares",
           "Narrow_Band_Processing_Parameters")


@pytest.fixture(scope="module")
def stream_npz(tmp_path_factory, small_stream):
    p = str(tmp_path_factory.mktemp("cli") / "stream.npz")
    small_stream.save_npz(p)
    return p


@pytest.fixture(scope="module")
def cfg_json(tmp_path_factory):
    p = str(tmp_path_factory.mktemp("cfg") / "cfg.json")
    NBLSConfig(
        FMIN=0.3, FMAX=2.0, NBANDS=3, WINLEN=40, WINLEN_1=50, WINLEN_X=30
    ).to_json(p)
    return p


@pytest.fixture
def restore_perf_defaults():
    from narrow_band_least_squares_tpu_torch import api

    prev = dict(api._PERF_DEFAULTS)
    yield
    api._PERF_DEFAULTS.clear()
    api.set_performance_defaults(**prev)


def test_defaults(capsys):
    main(["defaults"])
    d = json.loads(capsys.readouterr().out)
    assert d["FMIN"] == 0.1 and d["FREQ_BAND_TYPE"] == "log"
    assert d == NBLSConfig().to_dict()


def test_defaults_as_a_module():
    out = subprocess.run([sys.executable, "-m", "narrow_band_least_squares_tpu_torch",
                          "defaults"], cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout) == NBLSConfig().to_dict()


def test_run(stream_npz, cfg_json, tmp_path, capsys):
    out = str(tmp_path / "out")
    main(["run", "--data", stream_npz, "--out", out, "--no-figures",
          "--config", cfg_json, "--device", "cpu"])
    s = json.loads(capsys.readouterr().out)
    assert s["bands"] == 3
    assert os.path.exists(os.path.join(out, "narrow_band_results.txt"))
    assert os.path.exists(os.path.join(out, "config_used.json"))
    assert s["median_baz_deg"] == pytest.approx(230.0, abs=8.0)
    assert set(s["phases"]) == {"broadband", "narrowband", "persist"}
    assert not any(n.endswith(".png") for n in os.listdir(out))


def test_run_draws_the_figures(stream_npz, tmp_path, capsys):
    cfg = str(tmp_path / "cfg.json")
    NBLSConfig(FMIN=0.3, FMAX=2.0, NBANDS=3, WINLEN=40, WINLEN_1=50, WINLEN_X=30,
               dpi_num=20).to_json(cfg)
    out = str(tmp_path / "out")
    main(["run", "--data", stream_npz, "--out", out, "--config", cfg, "--device", "cpu"])
    s = json.loads(capsys.readouterr().out)
    assert "figures" in s["phases"]
    for name in FIGURES + ("Narrow_Band_Least_Squares_Sigma_Tau",):
        assert os.path.getsize(os.path.join(out, name + ".png")) > 0


def test_run_lts_draws_the_lts_figures(tmp_path, capsys, outlier_stream):
    data = str(tmp_path / "outlier.npz")
    outlier_stream.save_npz(data)
    cfg = str(tmp_path / "cfg.json")
    NBLSConfig(FMIN=0.2, FMAX=1.6, NBANDS=3, WINDOW_LENGTH_TYPE="constant",
               WINLEN=30, ALPHA=0.75, MDCCM_THRESH=0.5, dpi_num=20).to_json(cfg)
    out = str(tmp_path / "out")
    main(["run", "--data", data, "--out", out, "--config", cfg, "--device", "cpu"])
    json.loads(capsys.readouterr().out)
    for name in FIGURES + ("Narrow_Band_Least_Squares_LTS",
                           "Narrow_Band_Least_Squares_LTS_Dropped_Stations"):
        assert os.path.getsize(os.path.join(out, name + ".png")) > 0
    assert not os.path.exists(os.path.join(out, "Narrow_Band_Least_Squares_Sigma_Tau.png"))


def test_monitor_resume(stream_npz, cfg_json, tmp_path, capsys):
    out = str(tmp_path / "mon")
    args = ["monitor", "--data", stream_npz, "--segment-s", "120",
            "--out", out, "--config", cfg_json, "--device", "cpu"]
    main(args)
    n1 = json.loads(capsys.readouterr().out)["segments_processed"]
    main(args)
    n2 = json.loads(capsys.readouterr().out)["segments_processed"]
    assert n1 == 2 and n2 == 0
    main(args + ["--no-resume"])
    assert json.loads(capsys.readouterr().out)["segments_processed"] == 2


def test_nyquist_validation(stream_npz, tmp_path):
    # default config FMAX=5.0 on a 10 Hz stream -> clear error
    with pytest.raises(ValueError, match="Nyquist"):
        main(["run", "--data", stream_npz, "--out", str(tmp_path / "x"),
              "--no-figures", "--device", "cpu"])


def test_monitor_mseed_input(small_stream, cfg_json, tmp_path, capsys):
    """monitor accepts miniSEED input decoded by the port's native codec."""
    from narrow_band_least_squares_tpu_torch import native
    from test_ingest import make_int32_record

    assert native.get_lib() is not None, native.build_error
    st = small_stream
    # int32-quantized copy of the synthetic stream as one record per chunk
    scale = 1e4
    buf = b""
    coords = {}
    for c in range(st.nchans):
        sta = f"I53H{c + 1}"
        sid = f"IM.{sta}..BDF"
        coords[sid] = [st.latitudes[c], st.longitudes[c]]
        x = (st.data[c] * scale).astype(int)
        for k in range(0, st.npts, 500):
            block = x[k : k + 500]
            secs = k / st.fs
            buf += make_int32_record(
                list(block), sta=sta, fs=int(st.fs), reclen=4096,
                mm=int(secs // 60), ss=int(secs % 60),
            )
    ms = str(tmp_path / "data.mseed")
    with open(ms, "wb") as f:
        f.write(buf)
    cj = str(tmp_path / "coords.json")
    with open(cj, "w") as f:
        json.dump(coords, f)
    out = str(tmp_path / "mon")
    main(["monitor", "--config", cfg_json, "--data", ms, "--coords", cj,
          "--segment-s", "150", "--out", out, "--device", "cpu"])
    rep = json.loads(capsys.readouterr().out)
    assert rep["segments_processed"] >= 1
    with pytest.raises(SystemExit, match="--coords"):
        main(["monitor", "--data", ms, "--out", out, "--device", "cpu"])


def test_perf_overrides_roundtrip(tmp_path):
    """Perf knobs survive JSON round-trip and only non-defaults override."""
    cfg = NBLSConfig(max_lag_s=5.0, lts_funnel_k=8, lts_c_steps=6)
    p = str(tmp_path / "perf.json")
    cfg.to_json(p)
    back = NBLSConfig.from_json(p)
    assert back.perf_overrides() == {
        "max_lag_s": 5.0, "lts_funnel_k": 8, "c_steps": 6,
    }
    assert NBLSConfig().perf_overrides() == {}
    cfg2 = NBLSConfig(band_limit_db="auto")
    p2 = str(tmp_path / "auto.json")
    cfg2.to_json(p2)
    assert NBLSConfig.from_json(p2).perf_overrides() == {
        "band_limit_db": "auto",
    }


def test_run_with_perf_config(stream_npz, tmp_path, capsys, restore_perf_defaults):
    """The command line applies the config's pipeline options through
    api.set_performance_defaults; the TPU-only bounds are accepted."""
    from narrow_band_least_squares_tpu_torch import api

    cfgp = str(tmp_path / "cfg.json")
    NBLSConfig(
        FMIN=0.3, FMAX=2.0, NBANDS=3, WINLEN=40, WINLEN_1=50, WINLEN_X=30,
        max_lag_s=8.0, xcorr_chunk_mb=4.0, xcorr_method="fused",
    ).to_json(cfgp)
    out = str(tmp_path / "out")
    main(["run", "--data", stream_npz, "--out", out, "--no-figures",
          "--config", cfgp, "--device", "cpu"])
    s = json.loads(capsys.readouterr().out)
    assert s["median_baz_deg"] == pytest.approx(230.0, abs=8.0)
    assert api._PERF_DEFAULTS == {"max_lag_s": 8.0, "xcorr_chunk_mb": 4.0,
                                  "xcorr_method": "fused"}


REFUSED = [{"window_method": "patches"}]


@pytest.mark.parametrize("command", ["run", "monitor"])
@pytest.mark.parametrize("kw", REFUSED, ids=[next(iter(k.values())) for k in REFUSED])
def test_refused_options_raise(command, kw, stream_npz, tmp_path, restore_perf_defaults):
    """Options the command line once refused now run: ``window_method:
    "patches"`` writes the same results as the default config ('patches'
    is 'strided' extraction by another route; bucketing off moves no
    result by more than float rounding)."""
    outs = {}
    for name, extra in (("opt", kw), ("default", {})):
        cfgp = str(tmp_path / f"{name}.json")
        NBLSConfig(FMIN=0.3, FMAX=2.0, NBANDS=3, WINLEN=40, WINLEN_1=50, WINLEN_X=30,
                   **extra).to_json(cfgp)
        outs[name] = str(tmp_path / name)
        main([command, "--data", stream_npz, "--out", outs[name], "--config", cfgp,
              "--device", "cpu"] + (["--no-figures"] if command == "run" else
                                    ["--segment-s", "120"]))
    txt = sorted(f for f in os.listdir(outs["default"]) if f.endswith(".txt"))
    assert txt and txt == sorted(f for f in os.listdir(outs["opt"]) if f.endswith(".txt"))
    for f in txt:
        a = np.loadtxt(os.path.join(outs["opt"], f), skiprows=1)
        b = np.loadtxt(os.path.join(outs["default"], f), skiprows=1)
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4, err_msg=f)


@pytest.mark.parametrize("command", ["run", "monitor"])
def test_fft_method_runs(command, stream_npz, tmp_path, capsys, restore_perf_defaults):
    """``xcorr_method: "fft"`` (`ops.xcorr.cross_correlate`) runs through
    the command line and finds the synthetic source."""
    cfgp = str(tmp_path / "cfg.json")
    NBLSConfig(FMIN=0.3, FMAX=2.0, NBANDS=3, WINLEN=40, WINLEN_1=50, WINLEN_X=30,
               xcorr_method="fft").to_json(cfgp)
    argv = [command, "--data", stream_npz, "--out", str(tmp_path / "o"), "--config",
            cfgp, "--device", "cpu"] + (["--no-figures"] if command == "run" else
                                        ["--segment-s", "120"])
    main(argv)
    rep = json.loads(capsys.readouterr().out)
    if command == "run":
        assert rep["median_baz_deg"] == pytest.approx(230.0, abs=8.0)
    else:
        assert rep["segments_processed"] == 2


def test_unknown_device_is_refused(stream_npz, cfg_json, tmp_path):
    with pytest.raises(RuntimeError):
        main(["run", "--data", stream_npz, "--out", str(tmp_path / "o"),
              "--config", cfg_json, "--device", "nope"])
