"""Finds a cell's parts by name: `BENCHMARK.json` at the checkout's root,
``configs/<name>.json`` (the file a configuration entry names),
``traffic/<name>.json``, the entry point a traffic file names
(``entries/<name>.py``), ``metrics/<name>.py`` and ``counts/<name>.py``.
A new configuration, traffic mix, entry point or per-layer metric is a new
file and a new entry in `BENCHMARK.json`; nothing here names one.

A configuration runs one array (``"array"``) or a network of arrays
(``"arrays"``), never both; `arrays_of` reads either and refuses, naming the
file, what is malformed.  ``"array"`` is a ring of ``NCHANS`` elements,
``lat0``, ``lon0`` and ``aperture_km``, as
`reference.synthetic.default_array_coords` builds it.  ``"arrays"`` lists
two arrays or more, each with a name of its own and such a ring: every
array of a network has the configuration's ``NCHANS`` elements.  An array
holds no other key.

The entry contract (``entries/<name>.py``, class ``Entry``, built with the
configuration, the traffic's parameters, the `harness.traffic.Traffic`,
the device and the pipeline options): ``stream(call)`` makes what a call
hands over from ``call.data``, ``(C, span)`` for one array and
``(A, C, span)`` for a network of A, in the configuration's order;
``entry(stream)`` makes the call and returns the number of its segments
whose answers reached the caller; ``keep(g)`` and ``drop(g)`` keep and
drop segment ``g``'s answer for the check; ``answer(g, deployment)`` gives
it after the window, for a network a list of A answers in the
configuration's order (an answer is a dict with ``num_compute``, ``t``,
``mdccm``, ``vel``, ``baz`` and ``sig_tau``, see `harness.check`), where
None, or a list of another length, counts every array's answer missing;
``present(g, arrived)`` says whether a segment's answer reached the caller,
for the whole segment, every array of it; ``route()``, ``free()``,
``disk_bytes()`` and ``close()`` as `entries/api.py` shows.
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path
from types import ModuleType
from typing import List, Optional, Tuple

from portbench.reference.synthetic import default_array_coords

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent
ARRAY_NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
RING_KEYS = ("lat0", "lon0", "aperture_km")


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
                    cfg = json.load(f)
                arrays_of(cfg, c["file"])
                return cfg
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


def arrays_of(cfg: dict, where: str = "the configuration") -> List[Tuple[str, list, list]]:
    """Each array of configuration ``cfg`` as ``(name, lats, lons)``, in
    the file's order: one for ``"array"`` (named as the configuration), one
    an entry of ``"arrays"``.  Raises ValueError, naming ``where``, for a
    configuration with both keys or neither, a network of fewer than two
    arrays, a name missing, malformed or repeated, and an array that lacks
    a key of its ring or holds a key besides."""
    if ("array" in cfg) == ("arrays" in cfg):
        held = "both" if "array" in cfg else "neither of"
        raise ValueError(f"{where}: holds {held} 'array' and 'arrays'; a configuration "
                         f"runs one array or a network")
    n = int(cfg["NCHANS"])
    if "array" in cfg:
        return [_array(cfg["array"], cfg.get("name", "array"), RING_KEYS, n, where)]
    arrays = cfg["arrays"]
    if not isinstance(arrays, list) or len(arrays) < 2:
        raise ValueError(f"{where}: 'arrays' has to list 2 arrays or more (one array is "
                         f"'array')")
    names = [a.get("name") if isinstance(a, dict) else None for a in arrays]
    for i, name in enumerate(names):
        if not isinstance(name, str) or not ARRAY_NAME.match(name):
            raise ValueError(f"{where}: array {i} of 'arrays' has no well-formed 'name' "
                             f"(letters, digits, '_', '.', '-'): {name!r}")
    repeated = sorted({name for name in names if names.count(name) > 1})
    if repeated:
        raise ValueError(f"{where}: array names repeat in 'arrays': {', '.join(repeated)}")
    return [_array(a, name, ("name",) + RING_KEYS, n, where) for a, name in zip(arrays, names)]


def _array(arr: dict, name: str, keys: tuple, n: int, where: str) -> Tuple[str, list, list]:
    """Array ``name``'s ring, which holds ``keys`` and nothing else."""
    if not isinstance(arr, dict):
        raise ValueError(f"{where}: array {name!r} is no object of {', '.join(keys)}")
    lacks = [k for k in keys if k not in arr]
    besides = sorted(k for k in arr if k not in keys)
    if lacks or besides:
        raise ValueError(f"{where}: array {name!r} holds {', '.join(keys)} and nothing "
                         f"else; it lacks {lacks} and holds besides {besides}")
    lats, lons = default_array_coords(n, arr["aperture_km"], arr["lat0"], arr["lon0"])
    return name, lats, lons
