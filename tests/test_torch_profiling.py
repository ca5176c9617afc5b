"""PyTorch port: `utils.profiling` against the JAX package's.

`PhaseTimers` reports the same keys and `RunSummary` writes the same JSON
keys; `op_profile_summary` reads a Chrome trace, sums the duration of its
kernel, memcpy and memset events into ``device_busy_s`` (CPU events do not
count), lists them by name, holds no key for hardware counters
``torch.profiler`` does not record, and raises on a directory without a
trace; `trace` writes a trace that it reads.
"""

import json
import time

import pytest
import torch

from narrow_band_least_squares_tpu.utils import profiling as J
from narrow_band_least_squares_tpu_torch.utils import profiling as T


def _timed(mod):
    timers = mod.PhaseTimers()
    for name in ("filter", "solve", "filter"):
        with timers.phase(name):
            time.sleep(0.002)
    return timers


def test_phase_timers_keys_equal_jax():
    t, j = _timed(T).report(), _timed(J).report()
    assert list(t) == list(j) == ["filter", "solve"]
    for name in t:
        assert set(t[name]) == set(j[name]) == {"total_s", "calls", "mean_s"}
        assert t[name]["calls"] == j[name]["calls"]
        assert t[name]["mean_s"] == pytest.approx(t[name]["total_s"] / t[name]["calls"])
        assert t[name]["total_s"] >= 0.002 * t[name]["calls"]
    _timed(T).log()


def test_phase_timers_record_a_failing_phase():
    timers = T.PhaseTimers()
    with pytest.raises(RuntimeError):
        with timers.phase("broken"):
            raise RuntimeError("boom")
    assert timers.report()["broken"]["calls"] == 1


def test_run_summary_json_equals_jax():
    kw = dict(workload="canonical", nbands=8, num_compute_list=[39, 42, 46],
              nchans=8, alpha=1.0, device="cpu", wall_s=2.0,
              phases={"narrowband": {"total_s": 1.0, "calls": 1, "mean_s": 1.0}})
    t, j = T.RunSummary(**kw), J.RunSummary(**kw)
    assert json.loads(t.to_json()) == json.loads(j.to_json())
    assert t.total_solves == 127 and t.solves_per_s == 63.5
    assert T.RunSummary(**{**kw, "wall_s": 0.0}).solves_per_s == 0.0
    assert T.device_name("cpu") == "cpu"
    t.log()


def _event(cat, name, dur, ph="X"):
    return {"ph": ph, "cat": cat, "name": name, "pid": 0, "tid": 7, "ts": 0,
            "dur": dur}


def test_op_profile_summary_sums_device_events(tmp_path):
    events = [
        _event("kernel", "tc_tile_kernel<3,0>", 700.0),
        _event("kernel", "tc_tile_kernel<3,0>", 300.0),
        _event("kernel", "vectorized_elementwise_kernel", 50.0),
        _event("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 120.0),
        _event("gpu_memset", "Memset (Device)", 5.0),
        _event("cpu_op", "aten::mm", 9000.0),
        _event("cuda_runtime", "cudaLaunchKernel", 4000.0),
        _event("kernel", "flow start, not a duration", 1e6, ph="s"),
    ]
    (tmp_path / "00000000000000000001.pt.trace.json").write_text(
        json.dumps({"traceEvents": [_event("kernel", "older trace", 1e6)]}))
    (tmp_path / "00000000000000000002.pt.trace.json").write_text(
        json.dumps({"traceEvents": events}))
    s = T.op_profile_summary(str(tmp_path))
    assert s["device_busy_s"] == pytest.approx(1175e-6)
    assert [(k["name"], k["calls"]) for k in s["kernels"]] == [
        ("tc_tile_kernel<3,0>", 2), ("Memcpy HtoD (Pageable -> Device)", 1),
        ("vectorized_elementwise_kernel", 1), ("Memset (Device)", 1)]
    assert s["kernels"][0]["total_s"] == pytest.approx(1e-3)
    assert set(s) == {"device_busy_s", "kernels"}
    for key in ("hw_flop_util", "hbm_util", "hbm_bytes", "hbm_gbps", "tflops"):
        assert key not in s


def test_op_profile_summary_raises_without_a_trace(tmp_path):
    with pytest.raises(RuntimeError, match="no trace"):
        T.op_profile_summary(str(tmp_path))
    with pytest.raises(RuntimeError):
        J.op_profile_summary(str(tmp_path))


def test_trace_writes_a_trace_that_reads_back(tmp_path):
    x = torch.ones(64, 64)
    with T.trace(str(tmp_path / "t")) as prof:
        (x @ x).sum()
    assert prof is not None
    s = T.op_profile_summary(str(tmp_path / "t"))
    # the CPU has no device events: nothing is billed to a device
    assert s["device_busy_s"] == 0.0 and s["kernels"] == []
