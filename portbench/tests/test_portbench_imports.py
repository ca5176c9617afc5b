"""No module that ``portbench/run.py`` or the reference loads has the
top-level name ``jax``, ``jaxlib``, ``flax`` or
``narrow_band_least_squares_tpu`` (each module's name up to the first dot,
compared whole: the port's name begins with the JAX package's), and the
reference loads nothing of ``narrow_band_least_squares_tpu_torch``."""

import ast
import json
import subprocess
import sys

import pytest

from portbench.harness.spec import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "narrow_band_least_squares_tpu"}
PORT = "narrow_band_least_squares_tpu_torch"
FILES = sorted((ROOT / "portbench").rglob("*.py"))


def loaded(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\n"
                          "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
                         cwd=ROOT, capture_output=True, text=True, timeout=600,
                         env={"PATH": "/usr/bin:/bin", "PYTHONPATH": str(ROOT),
                              "HOME": str(ROOT / "build")})
    assert out.returncode == 0, out.stderr[-2000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_file_imports_jax(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        names = ([a.name for a in node.names] if isinstance(node, ast.Import) else
                 [node.module] if isinstance(node, ast.ImportFrom) and node.module
                 and node.level == 0 else [])
        for n in names:
            assert n.split(".")[0] not in FORBIDDEN, f"{path.name} imports {n}"
            if "reference" in path.parts:
                assert n.split(".")[0] != PORT, f"{path.name} imports {n}"


def test_reference_loads_neither_jax_nor_the_port():
    mods = loaded("import portbench.reference.batched, portbench.reference.ltsva, "
                  "portbench.reference.tsv, portbench.reference.synthetic")
    assert not (mods & FORBIDDEN) and PORT not in mods


def test_a_whole_run_loads_no_jax():
    """A short run of a cell on the CPU, the port and all, in its own
    process: the modules loaded at its end."""
    mods = loaded(
        "import importlib.util\n"
        "s = importlib.util.spec_from_file_location('r', 'portbench/run.py')\n"
        "m = importlib.util.module_from_spec(s); s.loader.exec_module(m)\n"
        "import contextlib, io\n"
        "with contextlib.redirect_stdout(io.StringIO()):\n"
        "    assert m.main(['--workload', 'i53.archive', '--seed', '4', '--seconds', '0.5',"
        " '--trace', '0'], device='cpu') == 0\n")
    assert PORT in mods and not (mods & FORBIDDEN)


def test_forbidden_check_compares_whole_names(monkeypatch):
    from conftest import load_run

    run = load_run()
    monkeypatch.setitem(sys.modules, "narrow_band_least_squares_tpu_torch_x", object())
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jaxlib.xla_client", object())
    assert run.forbidden_modules() == ["jaxlib"]
