"""The span readers on a step replayed from CUDA graphs
(``data/trace_graph.json``): one call replayed, one eager, and a replayed
call cut by the window's end.  A replayed kernel carries the correlation of
the ``cudaGraphLaunch`` that replayed it, so it belongs to the span around
that launch."""

import json
from pathlib import Path
from types import SimpleNamespace

import pytest

from portbench.harness import spans as S
from portbench.harness.spec import Spec
from portbench.harness.trace import Trace

DATA = Path(__file__).parent / "data"
GRAPH = json.loads((DATA / "trace_graph.json").read_text())["traceEvents"]
SPANS = json.loads((DATA / "trace_spans.json").read_text())["traceEvents"]
NO_SPANS = json.loads((DATA / "trace_small.json").read_text())["traceEvents"]
READERS = ("api_host_ms", "dispatch_host_ms", "package_ms", "filter_device_ms",
           "windows_device_ms", "spectra_device_ms", "solve_device_ms",
           "graph_replay_pct")


def ctx(events=GRAPH, segments=2):
    return SimpleNamespace(trace=Trace.from_events(events), segments=segments, calls=2,
                           window_s=1e-3)


def read(name, c):
    return Spec().module("metrics", name).read(c)


def test_replay_spans_nest_between_the_step_and_its_stages():
    sp = S.Spans(Trace.from_events(GRAPH))
    replays = [s for s in sp.spans if s.name == "nbls.graph.replay"]
    assert len(replays) == 2 and all(r.parent.name == "nbls.step" for r in replays)
    stages = [s for s in sp.spans if s.parent is replays[0]]
    assert [s.name for s in stages] == ["nbls.filter", "nbls.windows", "nbls.spectra",
                                        "nbls.lag_search", "nbls.solve"]
    # the replay's own time is what the stages leave: its glue's launches
    assert replays[0].self_us == pytest.approx(130 - 5 * 10)


def test_a_replayed_kernel_belongs_to_the_span_around_its_graph_launch():
    tr = Trace.from_events(GRAPH)
    sp = S.Spans(tr)
    owner = {(e["name"], e["ts"]): (s.name if s else None) for e, s in zip(tr.device, sp.owner)}
    assert owner["vectorized_elementwise_kernel<4, MulFunctor>", 1110.0] == "nbls.filter"
    assert owner["index_elementwise_kernel<128, 4>", 1120.0] == "nbls.windows"
    assert owner["void nbls::tc_tile_kernel<3, 0>(CUtensorMap, CUtensorMap, int)",
                 1190.0] == "nbls.lag_search"
    assert owner["sort_kernel", 1290.0] == owner["Memset (Device)", 1300.0] == \
        "nbls.graph.replay"
    assert owner["regular_fft<512>", 1430.0] == "nbls.filter"     # the eager call
    assert sp.device_us() == pytest.approx({
        "nbls.h2d": 10, "nbls.filter": 100, "nbls.windows": 20, "nbls.spectra": 50,
        "nbls.lag_search": 100, "nbls.graph.replay": 12, "nbls.solve": 16,
        "nbls.d2h": 10})


def test_graph_replay_pct_counts_the_calls_that_replayed():
    got = {n: read(n, ctx()) for n in READERS}
    # two calls lie in the window: one replayed, one eager (the third is cut)
    assert got["graph_replay_pct"] == pytest.approx(50.0)
    assert got["dispatch_host_ms"] == pytest.approx((0.160 + 0.200) / 2)
    assert got["filter_device_ms"] == pytest.approx(0.100 / 2)
    assert got["solve_device_ms"] == pytest.approx(0.016 / 2)
    replayed_only = [e for e in GRAPH if not (1400 <= e["ts"] < 1850)]
    assert read("graph_replay_pct", ctx(replayed_only)) == 100.0


def test_graph_replay_pct_reads_nothing_without_the_replay_span():
    eager_only = [e for e in GRAPH if e["name"] != "nbls.graph.replay"]
    assert read("graph_replay_pct", ctx(eager_only)) is None
    # the parent's eager trace, a trace with no spans, and spans with no device work
    assert read("graph_replay_pct", ctx(SPANS)) is None
    assert read("graph_replay_pct", ctx(NO_SPANS)) is None
    no_device = [e for e in SPANS if e["cat"] not in ("kernel", "gpu_memcpy", "gpu_memset")]
    assert read("graph_replay_pct", ctx(no_device)) is None
