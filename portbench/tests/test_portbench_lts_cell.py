"""The LTS cell ``i53.lts_archive``: its configuration, traffic and entries
load by name, the LTS solve's count at the plan's shapes, and the two
readers it adds (``stdict_host_ms``, ``lts_solve_roofline``) on a small
hand-written trace: one LTS call wholly inside the window, a second cut by
the window's end."""

import json
from pathlib import Path
from types import SimpleNamespace

import pytest

from portbench.harness.spec import ROOT, Spec
from portbench.harness.trace import Trace
from portbench.reference.batched import Deployment

DATA = Path(__file__).parent / "data"
EVENTS = json.loads((DATA / "trace_lts.json").read_text())["traceEvents"]
NO_SPANS = json.loads((DATA / "trace_small.json").read_text())["traceEvents"]
CELL, CONFIG = "i53.lts_archive", "i53_example_lts"
NEW = ("stdict_host_ms", "lts_solve_roofline")
SHARED = ("device_idle_pct", "launches_per_segment", "api_host_ms", "dispatch_host_ms",
          "package_ms", "solve_device_ms", "graph_replay_pct")
# the plan's shapes: 443 valid windows a segment, 28 pairs, 378 candidates
WINDOWS, P, Q, C_STEPS = 443, 28, 378, 4


def deployment(name=CONFIG):
    cfg = Spec().config(name)
    return cfg, Deployment(cfg, int(round(cfg["SEGMENT_S"] * cfg["FS"])))


def ctx(events=EVENTS, segments=2, name=CONFIG):
    cfg, dep = deployment(name)
    return SimpleNamespace(trace=Trace.from_events(events), segments=segments, calls=2,
                           window_s=1e-3, cfg=cfg, spec=Spec(), deployment=dep)


def test_the_cell_loads_by_name():
    spec = Spec()
    cell = spec.cell(CELL)
    assert (cell["config"], cell["traffic"], cell["chips"]) == (CONFIG, "archive_outlier", 1)
    assert {m["name"] for m in spec.end_to_end(CELL)} == {"segment_p95_ms", "setup_s"}
    layer = [m["name"] for m in spec.per_layer(CELL)]
    assert set(layer) == set(SHARED) | set(NEW)
    assert layer[-2:] == list(NEW)
    for name in NEW:
        assert callable(spec.module("metrics", name).read)


def test_the_configuration_is_the_example_at_alpha_075():
    spec = Spec()
    lts, ols = spec.config(CONFIG), spec.config("i53_example")
    assert lts["ALPHA"] == 0.75 and lts["options"] == {} and lts["reduced"] == []
    changed = {k for k in set(lts) | set(ols) if lts.get(k) != ols.get(k)}
    assert changed == {"name", "source", "deployment", "ALPHA", "guarantee", "assumed"}
    g, h = lts["guarantee"], ols["guarantee"]
    assert {k: v for k, v in g.items() if k != "what"} == \
        {k: v for k, v in h.items() if k != "what"}
    assert "stdict" in g["what"] and {"ALPHA", "outlier"} <= set(lts["assumed"])
    bench = {c["name"]: c for c in spec.bench["configs"]}[CONFIG]
    assert bench["source"] == lts["source"] and bench["file"] == \
        "portbench/configs/i53_example_lts.json"


def test_the_traffic_is_the_archive_with_element_3_incoherent():
    spec = Spec()
    mine, archive = spec.traffic("archive_outlier"), spec.traffic("archive")
    assert mine["source"] == dict(archive["source"], outlier_channels=[2])
    assert {k: v for k, v in mine.items() if k not in ("what", "source")} == \
        {k: v for k, v in archive.items() if k not in ("what", "source")}


def test_the_count_at_the_plans_shapes():
    counts = Spec().module("counts", "lts_solve")
    _, dep = deployment()
    assert sum(dep.num_compute_list) == WINDOWS and dep.c_steps == C_STEPS
    # the sweep's: W Q P (P - 1) / 2 (c_steps + 1), h = 21 of 28 kept
    sweep = WINDOWS * Q * (P * (P - 1) // 2) * (C_STEPS + 1)
    assert sweep == 316_488_060
    w = counts.work(WINDOWS, P, 0.75, C_STEPS)
    # the final subset adds its first minimum and one rank pass a window
    assert w["comparisons"] == sweep + WINDOWS * (Q - 1 + Q)
    assert counts.PEAK_COMPARES == pytest.approx(16.727e12, rel=1e-4)
    ms = counts.bound_seconds(WINDOWS, P, 0.75, C_STEPS) * 1e3
    assert ms == pytest.approx(w["comparisons"] / counts.PEAK_COMPARES * 1e3)
    assert ms == pytest.approx(0.01894, abs=5e-5)            # bound by the comparisons
    assert w["flops"] / 67e12 * 1e3 < ms and w["bytes"] / 3.35e12 * 1e3 < ms


def test_the_readers_read_the_trace():
    spec, c = Spec(), ctx()
    # the one call wholly inside the window: its stdict span, 180 us
    assert spec.module("metrics", "stdict_host_ms").read(c) == pytest.approx(0.180)
    # the host's stdict is part of the API's own time (440 - 100 - 100 us)
    assert spec.module("metrics", "api_host_ms").read(c) == pytest.approx(0.240)
    # every operation launched inside nbls.solve in the window: 40 + 10 + 50 us
    solve_ms = spec.module("metrics", "solve_device_ms").read(c)
    assert solve_ms == pytest.approx(0.050)
    bound_ms = spec.module("counts", "lts_solve").bound_seconds(WINDOWS, P, 0.75, C_STEPS) * 1e3
    got = spec.module("metrics", "lts_solve_roofline").read(c)
    assert got == pytest.approx(100.0 * bound_ms / solve_ms)


@pytest.mark.parametrize("name", NEW)
def test_the_readers_return_nothing_without_their_span(name):
    read = Spec().module("metrics", name).read
    assert read(ctx(NO_SPANS)) is None
    span = {"stdict_host_ms": "nbls.stdict", "lts_solve_roofline": "nbls.solve"}[name]
    assert read(ctx([e for e in EVENTS if e["name"] != span])) is None
    # spans with no device work (the CPU) read as none either
    assert read(ctx([e for e in EVENTS
                     if e["cat"] not in ("kernel", "gpu_memcpy", "gpu_memset")])) is None


def test_the_roofline_reads_nothing_for_ols_or_no_segment():
    read = Spec().module("metrics", "lts_solve_roofline").read
    assert read(ctx(name="i53_example")) is None
    assert read(ctx(segments=0)) is None


def test_the_benchmark_keeps_its_entries():
    """Only names appended to existing entries: the LTS cell's entries come
    after the entries that were there before them, and whatever was added
    later comes after them."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    earlier = ["i53.archive", "onethird.archive"]
    assert [w["name"] for w in bench["workloads"]][:3] == earlier + [CELL]
    assert [c["name"] for c in bench["configs"]][:3] == ["i53_example", "i53_onethird", CONFIG]
    layer = [m["name"] for m in bench["per_layer"]]
    assert layer[12:14] == list(NEW) and not set(layer[:12]) & set(NEW)
    for m in bench["end_to_end"] + bench["per_layer"]:
        if CELL in m.get("workloads", []):
            ws = m["workloads"]
            assert set(ws[:ws.index(CELL)]) <= set(earlier)
