"""The traced run: ``torch.profiler`` over the measured window, its Chrome
trace, and what the per-layer readers share: the device's operations, the
traced window, the device's busy time and its idle gaps by host op.

`device_rows` is a frozen copy of ``device_rows`` in
``narrow_band_least_squares_tpu_torch/utils/profiling.py`` at commit
3ee1e9bea504232cbf251ade8fbcb464f796f707: the device's work is the Chrome
trace's complete events of the kernel, memcpy and memset categories.
"""

from __future__ import annotations

import contextlib
import json
import os
import shutil
import tempfile
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Tuple

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATEGORIES = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver",
                   "python_function")
WINDOW_SPAN = "portbench.window"
CALL_SPAN = "portbench.call"
# host events searched back from a gap for the one running at its start
HOST_LOOKBACK = 4096


def device_rows(events: Iterable[dict]) -> List[Tuple[float, str, int]]:
    """``(device us, name, calls)`` per kernel, copy or memset name among
    Chrome-trace ``events`` (complete events of `DEVICE_CATEGORIES`),
    largest first."""
    total: Dict[str, float] = {}
    calls: Dict[str, int] = {}
    for e in events:
        if e.get("ph") != "X" or str(e.get("cat", "")).lower() not in DEVICE_CATEGORIES:
            continue
        name = e.get("name", "")
        total[name] = total.get(name, 0.0) + float(e.get("dur", 0.0))
        calls[name] = calls.get(name, 0) + 1
    return sorted(((us, name, calls[name]) for name, us in total.items()), reverse=True)


@dataclass
class Trace:
    """A traced window's events, clipped to the window's span (us)."""

    events: List[dict]
    t0: float
    t1: float
    device: List[dict] = field(default_factory=list)

    @classmethod
    def from_events(cls, events: List[dict]) -> "Trace":
        spans = [e for e in events if e.get("ph") == "X" and e.get("name") == WINDOW_SPAN]
        if not spans:
            raise ValueError(f"the trace holds no {WINDOW_SPAN!r} span")
        t0 = float(spans[0]["ts"])
        t1 = t0 + float(spans[0]["dur"])
        dev = [e for e in events if e.get("ph") == "X"
               and str(e.get("cat", "")).lower() in DEVICE_CATEGORIES
               and float(e["ts"]) < t1 and float(e["ts"]) + float(e.get("dur", 0)) > t0]
        return cls(events=events, t0=t0, t1=t1, device=dev)

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) * 1e-6

    def busy_intervals(self) -> List[Tuple[float, float]]:
        """The union of the device's operations, clipped to the window."""
        iv = sorted((max(self.t0, float(e["ts"])),
                     min(self.t1, float(e["ts"]) + float(e.get("dur", 0))))
                    for e in self.device)
        out: List[Tuple[float, float]] = []
        for a, b in iv:
            if b <= a:
                continue
            if out and a <= out[-1][1]:
                out[-1] = (out[-1][0], max(out[-1][1], b))
            else:
                out.append((a, b))
        return out

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) * 1e-6

    def gaps(self) -> List[Tuple[float, float]]:
        """The window's stretches with no operation on the device."""
        out, t = [], self.t0
        for a, b in self.busy_intervals():
            if a > t:
                out.append((t, a))
            t = max(t, b)
        if self.t1 > t:
            out.append((t, self.t1))
        return out

    def host_events(self) -> List[dict]:
        if not hasattr(self, "_host"):
            self._host = [e for e in self.events if e.get("ph") == "X"
                          and str(e.get("cat", "")).lower() in HOST_CATEGORIES
                          and e.get("name") != WINDOW_SPAN
                          and float(e["ts"]) < self.t1
                          and float(e["ts"]) + float(e.get("dur", 0)) > self.t0]
            self._host.sort(key=lambda e: float(e["ts"]))
        return self._host

    def idle_by_host_op(self) -> List[Tuple[str, float]]:
        """Idle seconds summed by the host op running as each gap starts
        (the innermost: the latest to start among those running), largest
        first."""
        import bisect

        host = self.host_events()
        starts = [float(e["ts"]) for e in host]
        calls = [e for e in host if e.get("name") == CALL_SPAN]
        total: Dict[str, float] = {}
        for a, b in self.gaps():
            t = a + min(0.5 * (b - a), 1.0)
            i = bisect.bisect_right(starts, t)
            name = None
            for e in reversed(host[max(0, i - HOST_LOOKBACK):i]):
                if float(e["ts"]) + float(e.get("dur", 0)) > t:
                    name = e["name"]
                    break
            if name is None:
                inside = any(float(c["ts"]) <= t < float(c["ts"]) + float(c["dur"])
                             for c in calls)
                name = CALL_SPAN if inside else "between calls"
            total[name] = total.get(name, 0.0) + (b - a) * 1e-6
        return sorted(total.items(), key=lambda kv: -kv[1])

    def breakdown(self, n: int = 10) -> dict:
        rows = device_rows(self.device)
        return {"device_ops": [[name, us * 1e-6] for us, name, _ in rows[:n]],
                "idle_gaps": [[name, s] for name, s in self.idle_by_host_op()[:n]]}


@contextlib.contextmanager
def profiled(cuda: bool = True):
    """``torch.profiler`` over the block, CPU and (``cuda``) CUDA; yields a holder whose
    ``trace`` is the parsed `Trace` once the block has ended.  The Chrome
    trace goes to a temporary directory under ``TMPDIR``, removed after
    it is read."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    holder = type("Holder", (), {"trace": None})()
    tmp = tempfile.mkdtemp(prefix="portbench_trace_")
    try:
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        with profile(activities=acts) as prof:
            yield holder
            if cuda:
                torch.cuda.synchronize()
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        del prof
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
        holder.trace = Trace.from_events(events)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
