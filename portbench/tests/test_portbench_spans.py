"""The span readers (``harness/spans.py`` and the metrics that read the
program's ``nbls.*`` spans) on a small hand-written Chrome trace whose
launches and device operations carry correlation ids: two calls, the
second cut by the window's end, and one launch between them."""

import json
from pathlib import Path
from types import SimpleNamespace

import pytest

from portbench.harness import spans as S
from portbench.harness.spec import Spec
from portbench.harness.trace import Trace

DATA = Path(__file__).parent / "data"
EVENTS = json.loads((DATA / "trace_spans.json").read_text())["traceEvents"]
NO_SPANS = json.loads((DATA / "trace_small.json").read_text())["traceEvents"]
READERS = ("api_host_ms", "dispatch_host_ms", "package_ms", "filter_device_ms",
           "windows_device_ms", "spectra_device_ms", "solve_device_ms")


def ctx(events=EVENTS, segments=2):
    return SimpleNamespace(trace=Trace.from_events(events), segments=segments, calls=2,
                           window_s=1e-3)


def test_self_time_subtracts_the_children():
    sp = S.Spans(Trace.from_events(EVENTS))
    (call,) = sp.calls()
    kids = {s.name: s for s in sp.spans if s.parent is call}
    assert set(kids) == {"nbls.api.plan", "nbls.step", "nbls.package"}
    assert call.self_us == pytest.approx(390 - 20 - 160 - 190)
    assert kids["nbls.step"].self_us == pytest.approx(160 - (10 + 40 + 20 + 30 + 20 + 15))
    assert kids["nbls.package"].self_us == pytest.approx(190 - 100 - 75)
    freqz = [s for s in sp.spans if s.name == "nbls.freqz"]
    assert [s.self_us for s in freqz] == [100.0] and freqz[0].parent is kids["nbls.package"]


def test_the_innermost_span_owns_a_launch():
    tr = Trace.from_events(EVENTS)
    sp = S.Spans(tr)
    owner = {e["name"]: (s.name if s else None) for e, s in zip(tr.device, sp.owner)}
    assert owner["vectorized_elementwise_kernel<4, MulFunctor>"] == "nbls.filter"
    assert owner["void nbls::tc_tile_kernel<3, 0>(CUtensorMap, CUtensorMap, int)"] \
        == "nbls.lag_search"                      # a driver launch
    assert owner["sort_kernel"] == "nbls.step"   # between the step's children
    assert owner["Memcpy DtoH (Device -> Pageable)"] == "nbls.d2h"
    assert sp.device_us() == pytest.approx({
        "nbls.h2d": 10, "nbls.filter": 60, "nbls.windows": 20, "nbls.spectra": 50,
        "nbls.lag_search": 100, "nbls.step": 10, "nbls.solve": 10, "nbls.d2h": 10,
        None: 5})


def test_a_launch_outside_every_span_is_unattributed():
    tr = Trace.from_events(EVENTS)
    sp = S.Spans(tr)
    (fill,) = [s for e, s in zip(tr.device, sp.owner) if e["name"] == "fill_kernel"]
    assert fill is None
    assert "before_window_kernel" not in {e["name"] for e in tr.device}
    # the device's copies of a span are no spans of the program
    assert sum(s.name == "nbls.step" for s in sp.spans) == 2


def test_only_calls_wholly_inside_the_window_count():
    sp = S.Spans(Trace.from_events(EVENTS))
    assert [(c.ts, c.end) for c in sp.calls()] == [(1005.0, 1395.0)]
    spec, c = Spec(), ctx()
    read = {n: spec.module("metrics", n).read(c) for n in READERS}
    assert read["api_host_ms"] == pytest.approx(0.040)    # the call less step and package
    assert read["dispatch_host_ms"] == pytest.approx(0.160)
    assert read["package_ms"] == pytest.approx(0.190)
    # device time counts every operation in the window, the cut call's too
    assert read["filter_device_ms"] == pytest.approx(0.030)
    assert read["windows_device_ms"] == pytest.approx(0.010)
    assert read["spectra_device_ms"] == pytest.approx(0.025)
    assert read["solve_device_ms"] == pytest.approx(0.005)


@pytest.mark.parametrize("name", READERS)
def test_readers_return_nothing_without_spans(name):
    spec = Spec()
    assert spec.module("metrics", name).read(ctx(NO_SPANS)) is None
    # spans with no device work (the CPU) read as none either
    no_device = [e for e in EVENTS if e["cat"] not in ("kernel", "gpu_memcpy", "gpu_memset")]
    assert spec.module("metrics", name).read(ctx(no_device)) is None
    if name.endswith("device_ms"):
        assert spec.module("metrics", name).read(ctx(segments=0)) is None


def test_spans_are_read_once_a_trace():
    tr = Trace.from_events(EVENTS)
    assert S.of(tr) is S.of(tr)
