"""The fused lag search's operations and bound from the plan's shapes
(``counts/fused_xcorr.py``: PERF.md §3, 1.2796 ms a canonical segment at
'highest', PERF.md §6's fused row; 2.5771 ms in third-octave bands), and
its reader ``fused_xcorr_roofline`` on a small hand-written trace whose
``nbls.lag_search`` span holds 100 us of device time over two segments."""

import json
from pathlib import Path
from types import SimpleNamespace

import pytest

from portbench.harness.spec import Spec
from portbench.harness.trace import Trace
from portbench.reference.batched import Deployment

DATA = Path(__file__).parent / "data"
EVENTS = json.loads((DATA / "trace_spans.json").read_text())["traceEvents"]
NO_SPANS = json.loads((DATA / "trace_small.json").read_text())["traceEvents"]
NCHANS, NPTS, PAIRS = 8, 24000, 28
BOUNDS_MS = {
    ("i53_example", "highest"): 1.2796, ("i53_example", "high"): 0.5196,
    ("i53_example", "default"): 0.1732,
    ("i53_onethird", "highest"): 2.5771, ("i53_onethird", "high"): 1.0464,
    ("i53_onethird", "default"): 0.3488,
}
# nbls.lag_search's operations in the trace: tc_tile's 100 us (the sort
# launched after the span's end is not its own)
LAG_SEARCH_US = 100.0


def shapes(name):
    dep = Deployment(Spec().config(name), NPTS)
    return [wp.winlensamp for wp in dep.windows], [wp.n_windows for wp in dep.windows]


def ctx(route, events=EVENTS, segments=2, name="i53_onethird_fp32"):
    spec = Spec()
    cfg = spec.config(name)
    return SimpleNamespace(trace=Trace.from_events(events), segments=segments, calls=2,
                           window_s=1e-3, route=route, cfg=cfg, params={}, spec=spec,
                           deployment=Deployment(cfg, NPTS))


@pytest.mark.parametrize("key", sorted(BOUNDS_MS), ids=lambda k: f"{k[0]}-{k[1]}")
def test_bound_reproduces_perf_md(key):
    counts = Spec().module("counts", "fused_xcorr")
    ms = counts.bound_seconds(*shapes(key[0]), NCHANS, NPTS, key[1]) * 1e3
    assert ms == pytest.approx(BOUNDS_MS[key], abs=6e-5)


@pytest.mark.parametrize("name", ["i53_example", "i53_onethird"])
def test_the_inverse_is_the_lag_searchs_count(name):
    spec = Spec()
    lens, wins = shapes(name)
    w = spec.module("counts", "fused_xcorr").work(lens, wins, NCHANS, NPTS)
    assert w["inverse"] == spec.module("counts", "lag_search").work(lens, wins, PAIRS)["flops"]
    assert w["flops"] == w["forward"] + w["inverse"]


@pytest.mark.parametrize("name", ["i53_example", "i53_onethird"])
def test_the_forward_is_each_bands_own(name):
    """2 L * 2 (L + 1) a window and element, band by band."""
    counts = Spec().module("counts", "fused_xcorr")
    lens, wins = shapes(name)
    for L, W in zip(lens, wins):
        assert counts.forward([L], [W], NCHANS) == 2.0 * L * 2 * (L + 1) * W * NCHANS
    assert counts.forward(lens, wins, NCHANS) == pytest.approx(
        {"i53_example": 10.722e9, "i53_onethird": 21.593e9}[name], rel=1e-4)


def test_the_operations_bound_it():
    """Compute-bound at every precision: the bytes take less time."""
    counts = Spec().module("counts", "fused_xcorr")
    w = counts.work(*shapes("i53_onethird"), NCHANS, NPTS)
    assert w["bytes"] / 3.35e12 < w["flops"] / 495e12 < w["flops"] / 67e12


@pytest.mark.parametrize("precision", ["highest", "high"])
def test_the_reader_reads_the_lag_search_span_on_the_fused_route(precision):
    c = ctx({"xcorr_method": "fused", "precision": precision})
    bound_ms = c.spec.module("counts", "fused_xcorr").bound_seconds(
        *shapes("i53_onethird"), NCHANS, NPTS, precision) * 1e3
    got = c.spec.module("metrics", "fused_xcorr_roofline").read(c)
    assert got == pytest.approx(100.0 * bound_ms / (LAG_SEARCH_US * 1e-3 / 2))


def test_the_reader_reads_nothing_off_the_fused_route():
    read = Spec().module("metrics", "fused_xcorr_roofline").read
    assert read(ctx({"xcorr_method": "mxu", "precision": "highest"})) is None
    fused = {"xcorr_method": "fused", "precision": "highest"}
    assert read(ctx(fused, events=NO_SPANS)) is None
    assert read(ctx(fused, events=[e for e in EVENTS if e["name"] != "nbls.lag_search"
                                   or e["cat"] != "user_annotation"])) is None
    assert read(ctx(fused, segments=0)) is None
