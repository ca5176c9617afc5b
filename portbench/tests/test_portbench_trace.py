"""The trace readers on a small hand-written Chrome trace: the traced
window, the device's busy time as the union of its operations, the idle
gaps by the host op running as each starts, launches a segment and the lag
search's kernel set."""

import json
from pathlib import Path
from types import SimpleNamespace

import pytest

from portbench.harness.spec import Spec
from portbench.harness.trace import Trace, device_rows
from portbench.reference.batched import Deployment

EVENTS = json.loads((Path(__file__).parent / "data" / "trace_small.json").read_text())["traceEvents"]


def ctx(segments=2, precision="high"):
    spec = Spec()
    cfg = spec.config("i53_example")
    return SimpleNamespace(trace=Trace.from_events(EVENTS), segments=segments, calls=2,
                           window_s=0.5,
                           route={"xcorr_method": "mxu", "precision": precision},
                           cfg=cfg, params={}, spec=spec, deployment=Deployment(cfg, 24000))


def test_window_busy_and_gaps():
    tr = Trace.from_events(EVENTS)
    assert tr.window_s == pytest.approx(1000e-6)
    assert len(tr.device) == 7        # the kernel before the window is out
    assert tr.busy_s() == pytest.approx(275e-6)
    assert tr.gaps() == [(1000.0, 1100.0), (1250.0, 1260.0), (1280.0, 1440.0),
                         (1450.0, 1600.0), (1605.0, 1700.0), (1750.0, 1960.0)]


def test_idle_gaps_named_by_host_op():
    got = dict(Trace.from_events(EVENTS).idle_by_host_op())
    assert got == pytest.approx({"portbench.call": 320e-6, "cudaStreamSynchronize": 160e-6,
                                 "aten::copy_": 150e-6, "aten::unfold": 95e-6})


def test_breakdown_shape():
    b = Trace.from_events(EVENTS).breakdown()
    assert set(b) == {"device_ops", "idle_gaps"}
    assert b["device_ops"][0][0].startswith("void nbls::tc_tile_kernel")
    assert len(b["device_ops"]) <= 10 and len(b["idle_gaps"]) <= 10


def test_device_rows_is_the_ports_definition():
    rows = device_rows(EVENTS)
    assert rows[0][1].startswith("void nbls::tc_tile_kernel") or rows[0][0] == 100.0
    assert sum(r[2] for r in rows) == 8     # every device event, window or not


def test_device_idle_and_launches():
    spec = Spec()
    c = ctx()
    assert spec.module("metrics", "device_idle_pct").read(c) == pytest.approx(72.5)
    assert spec.module("metrics", "launches_per_segment").read(c) == pytest.approx(3.5)


def test_lag_search_roofline_reads_its_kernels():
    spec = Spec()
    c = ctx(precision="default")
    bound = spec.module("counts", "lag_search").bound_seconds(
        [wp.winlensamp for wp in c.deployment.windows],
        [wp.n_windows for wp in c.deployment.windows], 28, "default")
    # tc_tile 100 + peak_merge 100 + tf32_split 20 us; not other_merge_kernel_x
    want = 100.0 * bound * 2 / 220e-6
    assert spec.module("metrics", "lag_search_roofline").read(c) == pytest.approx(want)


def test_readers_return_nothing_without_a_device():
    spec = Spec()
    events = [e for e in EVENTS if e["cat"] not in ("kernel", "gpu_memcpy", "gpu_memset")]
    c = ctx()
    c.trace = Trace.from_events(events)
    for name in ("device_idle_pct", "launches_per_segment", "lag_search_roofline"):
        assert spec.module("metrics", name).read(c) is None


def test_call_rate_of_the_traced_window():
    spec = Spec()
    c = ctx()
    assert spec.module("metrics", "call_windows_per_s").read(c) == pytest.approx(2 * 443 / 0.5)
    c.segments = 0
    assert spec.module("metrics", "call_windows_per_s").read(c) is None
