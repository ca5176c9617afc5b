"""`BENCHMARK.json` and the files it names: each is found by name and
parses, the entries keep the contract's shape, and a new configuration,
traffic mix or per-layer metric is a new file and a new entry."""

import json
import re
import shutil

import numpy as np

import pytest

from portbench.harness.spec import ROOT, Spec

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


def test_top_level_keys_and_command():
    assert set(BENCH) == KEYS
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51


def option_faults(d: dict, why: str) -> list:
    """What is wrong with configuration ``d``'s ``options`` (its entry's
    ``why`` beside it): each key has to be a keyword parameter of the
    port's ``NarrowBandPipeline`` (the harness hands them to it), and each
    option has to be named, by key or by value, in the file's
    ``deployment`` and in the entry's ``why``, since a configuration off
    the port's defaults is another deployment.  Empty: the port's
    defaults, what users get."""
    import inspect

    from narrow_band_least_squares_tpu_torch.models import NarrowBandPipeline

    params = inspect.signature(NarrowBandPipeline).parameters
    keywords = {n for n, p in params.items()
                if p.kind in (p.POSITIONAL_OR_KEYWORD, p.KEYWORD_ONLY)
                and p.default is not p.empty}
    faults = []
    for key, value in d["options"].items():
        if key not in keywords:
            faults.append(f"{key!r} is not a keyword of NarrowBandPipeline")
        for where, text in (("deployment", d["deployment"]), ("why", why)):
            if key not in text and str(value) not in text:
                faults.append(f"{key!r} is not named in the {where}")
    return faults


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file_found_and_parses(cfg):
    spec = Spec()
    d = spec.config(cfg["name"])
    assert d["name"] == cfg["name"] and d["source"] == cfg["source"]
    assert cfg["file"].startswith("portbench/configs/") and NAME.match(cfg["name"])
    assert set(cfg) == {"name", "source", "file", "reduced", "why"}
    assert d["dtype"] == "float32" and d["reduced"] == cfg["reduced"] == []
    assert option_faults(d, cfg["why"]) == []
    g = d["guarantee"]
    assert g["mdccm_abs"] > 0 and 0 < g["window_share"] < 1


def test_a_configuration_with_an_option_the_port_lacks_is_refused(tmp_path):
    """A configuration whose ``options`` names a key ``NarrowBandPipeline``
    does not take, in a temporary checkout, fails the check above; the
    same configuration with the port's keywords passes it."""
    shutil.copytree(ROOT / "portbench/configs", tmp_path / "portbench/configs")
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    entry = {"name": "odd_route", "source": BENCH["configs"][0]["source"],
             "file": "portbench/configs/odd_route.json", "reduced": [],
             "why": "a test: xcorr_method fused"}
    bench["configs"].append(entry)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cfg = json.loads((ROOT / "portbench/configs/i53_example.json").read_text())
    cfg.update(name="odd_route", deployment="a test on the fused route",
               options={"xcorr_method": "fused", "xcorr_algorithm": "fused"})
    (tmp_path / entry["file"]).write_text(json.dumps(cfg))
    d = Spec(tmp_path).config("odd_route")
    assert option_faults(d, entry["why"]) == [
        "'xcorr_algorithm' is not a keyword of NarrowBandPipeline"]
    del d["options"]["xcorr_algorithm"]
    assert option_faults(d, entry["why"]) == []
    # an option the deployment and the why leave unsaid is refused too
    d["options"]["matmul_precision"] = "default"
    assert option_faults(d, entry["why"]) == [
        "'matmul_precision' is not named in the deployment",
        "'matmul_precision' is not named in the why"]


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_traffic_found_and_parses(cell):
    spec = Spec()
    t = spec.traffic(cell["traffic"])
    assert callable(spec.module("entries", t["entry"]).Entry)
    assert all(len(v) == 2 and v[0] < v[1] for v in t["draw"].values())
    assert t["pool_segments"] % t["segments_per_call"] == 0
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert cell["chips"] == 1 and len(cell["why"]) <= 200
    assert spec.end_to_end(cell["name"]) and spec.per_layer(cell["name"])
    assert "setup_s" in {m["name"] for m in spec.end_to_end(cell["name"])}


@pytest.mark.parametrize("metric", BENCH["per_layer"], ids=lambda m: m["name"])
def test_metric_reader_found(metric):
    spec = Spec()
    assert callable(spec.module("metrics", metric["name"]).read)
    assert UNIT.match(metric["unit"])
    assert set(metric) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
    # every cell it lists reports the end-to-end metric it moves
    for cell in metric["workloads"]:
        assert metric["moves"] in {m["name"] for m in spec.end_to_end(cell)}


@pytest.mark.parametrize("metric", BENCH["end_to_end"], ids=lambda m: m["name"])
def test_end_to_end_entries(metric):
    assert metric["source"] in ("host_clock", "device_trace")
    assert 0.01 <= metric["bound"] <= 0.25 and UNIT.match(metric["unit"])


def test_names_are_unique_and_well_formed():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in BENCH[group]]
        assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


THROWAWAY_ENTRY = """
import importlib.util, json, os

_here = os.path.dirname(os.path.abspath(__file__))
_spec = importlib.util.spec_from_file_location("throwaway_api", os.path.join(_here, "api.py"))
_api = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_api)


class Entry(_api.Entry):
    def __init__(self, cfg, params, traffic, device, options):
        with open(os.path.join(_here, "seen.json"), "w") as f:
            json.dump({"options": options, "tag": params["tag"]}, f)
        super().__init__(cfg, params, traffic, device, options)
"""


def test_a_new_config_traffic_entry_and_metric_are_files_and_entries(tmp_path):
    """Copies the benchmark into a temporary checkout, adds a configuration
    that sets a route option, a traffic mix that names a new entry point
    and passes a new argument to the generator, and a per-layer metric, by
    new files and new entries only, and runs the new cell on the CPU: the
    harness finds each by name and hands each its parameters."""
    from conftest import run_cell

    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads((ROOT / "portbench/configs/i53_example.json").read_text())
    cfg.update(name="throwaway_cfg", NBANDS=2, SEGMENT_S=300.0,
               options={"matmul_precision": "default"})
    (tmp_path / "portbench/configs/throwaway_cfg.json").write_text(json.dumps(cfg))
    traffic = json.loads((ROOT / "portbench/traffic/archive.json").read_text())
    traffic.update(entry="throwaway_entry", pool_segments=2, warmup_calls=1,
                   check_segments=1, tag="seen")
    traffic["source"]["outlier_channels"] = [2]
    (tmp_path / "portbench/traffic/throwaway-mix.json").write_text(json.dumps(traffic))
    (tmp_path / "portbench/entries/throwaway_entry.py").write_text(THROWAWAY_ENTRY)
    (tmp_path / "portbench/metrics/throwaway.metric.py").write_text(
        "def read(ctx):\n    return 42.0\n")
    bench["configs"].append({"name": "throwaway_cfg", "source": cfg["source"],
                             "file": "portbench/configs/throwaway_cfg.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "throwaway.cell", "config": "throwaway_cfg",
                               "traffic": "throwaway-mix", "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "throwaway.metric", "unit": "%", "better": "higher",
                               "source": "program_counter", "layer": "device",
                               "moves": "segment_p95_ms", "workloads": ["throwaway.cell"]})
    for m in bench["end_to_end"]:
        if m["name"] == "segment_p95_ms":
            m["workloads"].append("throwaway.cell")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    spec = Spec(tmp_path)
    assert spec.config(spec.cell("throwaway.cell")["config"])["NBANDS"] == 2
    assert spec.traffic("throwaway-mix")["pool_segments"] == 2
    assert [m["name"] for m in spec.per_layer("throwaway.cell")] == ["throwaway.metric"]
    assert spec.module("metrics", "throwaway.metric").read(None) == 42.0
    assert "segment_p95_ms" in [m["name"] for m in spec.end_to_end("throwaway.cell")]

    from portbench.harness.traffic import Traffic

    plain = Traffic(cfg, dict(traffic, source={k: v for k, v in traffic["source"].items()
                                               if k != "outlier_channels"}), 7)
    odd = Traffic(cfg, traffic, 7)
    assert np.array_equal(odd.segment(0)[1], plain.segment(0)[1])
    assert not np.allclose(odd.segment(0)[2], plain.segment(0)[2])

    rc, last, text = run_cell(["--workload", "throwaway.cell", "--seed", "7", "--seconds",
                               "0.2", "--trace", "0"], root=tmp_path)
    assert rc == 0 and last["attempted"] >= 1, text
    seen = json.loads((tmp_path / "portbench/entries/seen.json").read_text())
    assert seen == {"options": {"matmul_precision": "default"}, "tag": "seen"}
