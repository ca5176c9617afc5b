"""Finds a cell's parts by name: `BENCHMARK.json` at the checkout's root,
``configs/<name>.json`` (the file a configuration entry names),
``traffic/<name>.json``, the entry point a traffic file names
(``entries/<name>.py``), ``metrics/<name>.py`` and ``counts/<name>.py``.
A new configuration, traffic mix, entry point or per-layer metric is a new
file and a new entry in `BENCHMARK.json`; nothing here names one."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import List, Optional

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


class Spec:
    """`BENCHMARK.json` and the files it names, under ``root``."""

    def __init__(self, root: Path = ROOT, bench_dir: Optional[Path] = None):
        self.root = Path(root)
        self.dir = Path(bench_dir) if bench_dir is not None else self.root / BENCH_DIR.name
        with open(self.root / "BENCHMARK.json") as f:
            self.bench = json.load(f)

    def cell(self, name: str) -> dict:
        for w in self.bench["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.bench["configs"]:
            if c["name"] == name:
                with open(self.root / c["file"]) as f:
                    return json.load(f)
        raise KeyError(f"no configuration {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        with open(self.dir / "traffic" / f"{name}.json") as f:
            return json.load(f)

    def end_to_end(self, cell: str) -> List[dict]:
        """The end-to-end metrics the cell reports."""
        return [m for m in self.bench["end_to_end"]
                if "workloads" not in m or cell in m["workloads"]]

    def per_layer(self, cell: str) -> List[dict]:
        """The per-layer metrics read in the cell: those that list it, and
        those without a list whose end-to-end metric the cell reports."""
        reported = {m["name"] for m in self.end_to_end(cell)}
        return [m for m in self.bench["per_layer"]
                if (cell in m["workloads"] if "workloads" in m
                    else m["moves"] in reported)]

    def module(self, kind: str, name: str) -> ModuleType:
        """``<kind>/<name>.py`` of the benchmark's folder, loaded by path
        (a name may hold '.' or '-')."""
        path = self.dir / kind / f"{name}.py"
        spec = importlib.util.spec_from_file_location(
            f"portbench_{kind}_{name.replace('.', '_').replace('-', '_')}", path)
        if spec is None or spec.loader is None:
            raise ImportError(f"cannot load {path}")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod
