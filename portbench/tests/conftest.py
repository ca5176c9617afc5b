"""The benchmark's own tests (``python -m pytest portbench/tests``), on the
CPU; those marked ``card`` need CUDA and skip without it.  Apart from the
repo's ``tests/``: they import neither JAX nor the JAX package."""

import importlib.util
import io
import json
import sys
from contextlib import redirect_stdout
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    """Skips the test where there is no CUDA card."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run on the chip")
    return "cuda"


def load_run(root=ROOT):
    spec = importlib.util.spec_from_file_location("portbench_run", root / "portbench" / "run.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_cell(argv, device="cpu", options=None, root=ROOT):
    """``run.main`` of the checkout at ``root`` in this process; returns
    (exit code, last line parsed or None, everything printed)."""
    out = io.StringIO()
    with redirect_stdout(out):
        rc = load_run(root).main(argv, device=device, options=options)
    text = out.getvalue()
    lines = [ln for ln in text.splitlines() if ln.strip()]
    last = json.loads(lines[-1]) if rc == 0 and lines else None
    return rc, last, text


@pytest.fixture
def run():
    return run_cell
