"""PyTorch port: import boundaries and device selection.

The port and ``chip_smoke.py`` import neither ``jax`` nor the JAX package,
and no port file names the JAX package's native directory or its shared
object (the port builds its own); importing the port builds no kernel and
starts no compiler; an entry point given no ``device`` (the command line
given no ``--device``) runs on CUDA and raises where CUDA is absent, never
falling back to the CPU; importing the port leaves matplotlib unloaded (only
its figure code imports it).
"""

import ast
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "narrow_band_least_squares_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "narrow_band_least_squares_tpu")


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("path", FILES, ids=[str(p.relative_to(ROOT)) for p in FILES])
def test_no_jax_imports(path):
    for mod in _imports(path):
        top = mod.split(".")[0]
        assert top not in FORBIDDEN, f"{path.name} imports {mod}"


PORT_FILES = sorted(p for p in PORT.rglob("*") if p.is_file()
                    and p.suffix in (".py", ".cpp", ".cu", ".cuh"))


@pytest.mark.parametrize("path", PORT_FILES + [ROOT / "chip_smoke.py"],
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES] + ["chip_smoke.py"])
def test_no_reference_to_the_jax_native_library(path):
    text = path.read_text()
    for name in ("narrow_band_least_squares_tpu/native", "narrow_band_least_squares_tpu.native",
                 "libnbls_native.so"):
        assert name not in text, f"{path.name} names {name}"


def test_importing_io_builds_nothing_and_starts_no_compiler():
    code = (
        "import subprocess, sys\n"
        "def refuse(*a, **k):\n"
        "    raise AssertionError(f'a process was started at import: {a[:1]}')\n"
        "subprocess.Popen = subprocess.run = subprocess.call = refuse\n"
        "import narrow_band_least_squares_tpu_torch.io as io\n"
        "from narrow_band_least_squares_tpu_torch.io import (\n"
        "    earthworm, fdsn, ingest, response, stream, textio)\n"
        "from narrow_band_least_squares_tpu_torch import native\n"
        "assert native._lib is None and native.build_error is None\n"
        "assert io.gather_waveforms is stream.gather_waveforms\n"
        "assert io.StreamingIngest is ingest.StreamingIngest\n"
        "assert io.RingBuffer is ingest.RingBuffer and io.MSRecord is ingest.MSRecord\n"
        "assert io.read_mseed_records is ingest.read_mseed_records\n"
        "assert io.read_mseed is ingest.read_mseed\n"
        "assert io.mseed_to_stream is ingest.mseed_to_stream\n"
        "assert not any(m.split('.')[0] in ('jax', 'narrow_band_least_squares_tpu')"
        " for m in sys.modules)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_chip_smoke_runs_the_ingest_and_golden_phases():
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    phases = next(ast.literal_eval(node.value) for node in ast.walk(tree)
                  if isinstance(node, ast.Assign)
                  and any(getattr(t, "id", None) == "PHASES" for t in node.targets))
    assert "ingest" in phases and "golden" in phases
    assert phases.index("ingest") < phases.index("timing")
    assert phases.index("golden") < phases.index("timing")


def test_chip_smoke_runs_the_cli_phase():
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    phases = next(ast.literal_eval(node.value) for node in ast.walk(tree)
                  if isinstance(node, ast.Assign)
                  and any(getattr(t, "id", None) == "PHASES" for t in node.targets))
    assert "cli" in phases and phases.index("cli") < phases.index("timing")
    names = {node.name for node in ast.walk(tree) if isinstance(node, ast.FunctionDef)}
    assert {"phase_cli", "cli_canonical", "cli_monitor", "cli_fetch_run"} <= names


def test_importing_the_port_leaves_matplotlib_out():
    code = (
        "import sys\n"
        "import narrow_band_least_squares_tpu_torch as p\n"
        "from narrow_band_least_squares_tpu_torch import api, config, models, parallel\n"
        "from narrow_band_least_squares_tpu_torch import __main__ as cli\n"
        "from narrow_band_least_squares_tpu_torch.utils import profiling\n"
        "from narrow_band_least_squares_tpu_torch.examples import (\n"
        "    example, example_monitoring, example_streaming_ingest)\n"
        "assert p.NBLSConfig is config.NBLSConfig\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] == 'matplotlib')\n"
        "assert not bad, bad[:5]\n"
        "from narrow_band_least_squares_tpu_torch import plotting\n"
        "assert 'matplotlib' in sys.modules\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_import_builds_nothing():
    code = (
        "import sys, narrow_band_least_squares_tpu_torch as p\n"
        "from narrow_band_least_squares_tpu_torch import api, models, ops, state\n"
        "from narrow_band_least_squares_tpu_torch.ops import lts, solve\n"
        "from narrow_band_least_squares_tpu_torch.ops.kernels import _build, xcorr_peak\n"
        "from narrow_band_least_squares_tpu_torch.ops.kernels import fused_xcorr\n"
        "from narrow_band_least_squares_tpu_torch.models import (\n"
        "    BroadbandPipeline, MultiArrayPipeline, StreamingMonitor)\n"
        "from narrow_band_least_squares_tpu_torch.models import streaming\n"
        "from narrow_band_least_squares_tpu_torch.parallel import (\n"
        "    ShardedNarrowBandPipeline, sharded)\n"
        "from narrow_band_least_squares_tpu_torch.io import textio\n"
        "assert xcorr_peak._bound is None and fused_xcorr._bound is None\n"
        "assert xcorr_peak._bound_tc is None\n"
        "assert not _build._libs\n"
        "assert p.MultiArrayPipeline is MultiArrayPipeline\n"
        "assert p.BroadbandPipeline is BroadbandPipeline\n"
        "assert p.StreamingMonitor is StreamingMonitor\n"
        "assert p.ShardedNarrowBandPipeline is ShardedNarrowBandPipeline\n"
        "assert p.write_txtfile is textio.write_txtfile is api.write_txtfile\n"
        "assert p.read_txtfile is textio.read_txtfile is api.read_txtfile\n"
        "assert not any(m.split('.')[0] in ('jax', 'narrow_band_least_squares_tpu')"
        " for m in sys.modules), sorted(m for m in sys.modules if 'jax' in m)[:5]\n"
        "assert callable(p.narrow_band_least_squares)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_entry_points_without_device_raise_without_cuda(small_stream, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this box has CUDA: the default device is usable")
    from narrow_band_least_squares_tpu_torch import api
    from narrow_band_least_squares_tpu_torch.io.stream import ArrayStream
    from narrow_band_least_squares_tpu_torch.models import (
        BroadbandPipeline, NarrowBandPipeline, StreamingMonitor,
    )
    from narrow_band_least_squares_tpu_torch.parallel import ShardedNarrowBandPipeline
    from narrow_band_least_squares_tpu_torch.utils import (
        get_freqlist, get_rij, get_winlenlist, make_plan,
    )

    from narrow_band_least_squares_tpu_torch.__main__ import main as cli_main

    st = small_stream
    tst = ArrayStream(data=st.data, fs=st.fs, start_epoch=st.start_epoch,
                      latitudes=list(st.latitudes), longitudes=list(st.longitudes))
    npz = str(tmp_path / "stream.npz")
    tst.save_npz(npz)
    fl, nb, _ = get_freqlist(0.3, 1.2, "log", 2)
    wl = get_winlenlist("constant", nb, 30, 0, 0)
    plan = make_plan(fl, "log", wl, 0.5, st.npts, st.fs)
    rij = get_rij(st.latitudes, st.longitudes, st.nchans)
    fr = np.logspace(-2, 0, 10)
    calls = [
        lambda: NarrowBandPipeline(plan, rij),
        lambda: NarrowBandPipeline(plan, rij, xcorr_method="fused"),
        lambda: BroadbandPipeline(0.3, 1.2, 30.0, 0.5, st.npts, st.fs, rij),
        lambda: ShardedNarrowBandPipeline(plan, rij),
        lambda: StreamingMonitor(plan, rij, str(tmp_path), fl),
        lambda: api.filter_data(tst, "cheby1", 0.3, 1.2, 2, 0.01),
        lambda: api.ltsva(tst, st.latitudes, st.longitudes, 30, 0.5),
        lambda: api.narrow_band_least_squares(
            wl, 0.5, 1.0, tst, st.latitudes, st.longitudes, nb, None, None,
            fl, "log", fr, "cheby1", 2, 0.01),
        lambda: api.narrow_band_loop(
            0, fl, "log", fr, tst, "cheby1", 2, 0.01, st.latitudes,
            st.longitudes, wl, 0.5, 1.0, 30),
        lambda: cli_main(["run", "--data", npz, "--out", str(tmp_path / "run"),
                          "--no-figures"]),
        lambda: cli_main(["run", "--synthetic", "--out", str(tmp_path / "syn")]),
        lambda: cli_main(["monitor", "--data", npz, "--out", str(tmp_path / "mon"),
                          "--segment-s", "120"]),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


def test_importing_the_mesh_modules_starts_nothing():
    """The mesh, the worker and the parallel example import neither JAX nor
    the JAX package, join no process group and start no process (torch and
    SciPy are imported first: they may ask the system about the CPU)."""
    code = (
        "import subprocess, sys\n"
        "import scipy.signal, torch.distributed as dist\n"
        "def refuse(*a, **k):\n"
        "    raise AssertionError(f'a process was started at import: {a[:1]}')\n"
        "subprocess.Popen = subprocess.run = subprocess.call = refuse\n"
        "from narrow_band_least_squares_tpu_torch.parallel import (\n"
        "    Mesh, auto_mesh_shape, initialize_distributed, make_mesh, mesh, smoke)\n"
        "from narrow_band_least_squares_tpu_torch.examples import example_parallel\n"
        "from narrow_band_least_squares_tpu_torch.ops.xcorr import cross_correlate\n"
        "assert not dist.is_initialized()\n"
        "assert make_mesh is mesh.make_mesh and Mesh is mesh.Mesh\n"
        "assert not any(m.split('.')[0] in ('jax', 'narrow_band_least_squares_tpu')"
        " for m in sys.modules)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_oracle_imports_neither_torch_nor_jax():
    """The port's NumPy oracle runs where there is neither torch nor JAX:
    importing it (and running its smallest piece) loads neither, nor the
    JAX package."""
    code = (
        "import sys\n"
        "import numpy as np\n"
        "from narrow_band_least_squares_tpu_torch import oracle\n"
        "from narrow_band_least_squares_tpu_torch.oracle import ltsva, pipeline\n"
        "assert oracle.ltsva_oracle is ltsva.ltsva_oracle\n"
        "assert oracle.narrow_band_least_squares_oracle is "
        "pipeline.narrow_band_least_squares_oracle\n"
        "sos = oracle.design_sos('cheby1', 0.5, 2.0, 2, 0.01, 10.0)\n"
        "assert sos.shape == (2, 6)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('torch', 'jax', 'jaxlib', 'narrow_band_least_squares_tpu'))\n"
        "assert not bad, bad[:5]\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_new_kernel_module_imports_build_nothing():
    """The sosfilt kernel's module and the filters and windows that use it
    import without building; the package namespace ``ops.kernels.sosfilt``
    is the module (its launch count lives there)."""
    code = (
        "import sys\n"
        "from narrow_band_least_squares_tpu_torch.ops import filters, windows, xcorr\n"
        "from narrow_band_least_squares_tpu_torch.ops.kernels import _build, sosfilt\n"
        "from narrow_band_least_squares_tpu_torch.ops.kernels import xcorr_peak\n"
        "assert sosfilt._bound is None and not _build._libs\n"
        "assert sosfilt.launches == 0 and callable(sosfilt.sosfilt)\n"
        "assert xcorr_peak.launches_nb == 0 and xcorr_peak.launches_nb_tc == 0\n"
        "assert callable(filters.sosfilt_scan) and callable(filters.filter_stream_scan)\n"
        "assert callable(windows.extract_windows_patches)\n"
        "assert callable(xcorr.subsample_frac)\n"
        "assert not any(m.split('.')[0] in ('jax', 'narrow_band_least_squares_tpu')"
        " for m in sys.modules)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_chip_smoke_runs_the_options_phase():
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    phases = next(ast.literal_eval(node.value) for node in ast.walk(tree)
                  if isinstance(node, ast.Assign)
                  and any(getattr(t, "id", None) == "PHASES" for t in node.targets))
    assert "options" in phases and phases.index("options") < phases.index("timing")
    names = {node.name for node in ast.walk(tree) if isinstance(node, ast.FunctionDef)}
    assert {"phase_options", "options_kernel", "options_subsample", "options_sosfilt",
            "options_oracle", "options_timing"} <= names
