"""Phase timers, device traces and structured run summaries.

The port's copy of ``narrow_band_least_squares_tpu/utils/profiling.py``:

- `PhaseTimers`: wall-clock per-phase timers with a structured report; a
  phase ends by synchronizing the current CUDA device (where CUDA is
  initialized), so it is billed for the device work it queued,
- `trace`: a ``torch.profiler`` run of a block, exported as a Chrome trace,
- `op_profile_summary`: the device time of a captured trace, in total and
  by kernel name (`device_rows` is the one definition of device busy time
  that the command line and ``chip_smoke.py`` share),
- `span`: a named range of the program's host work, recorded into the
  trace while a ``torch.profiler`` session records and free otherwise
  (while a step is captured into CUDA graphs, also where one graph ends
  and the next begins: `capturing`),
- `RunSummary`: the per-run record (windows per band, solves per second,
  device) serializable to JSON.
"""

from __future__ import annotations

import contextlib
import glob
import json
import logging
import os
import time
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Tuple

import torch

logger = logging.getLogger("nbls_torch")

# Chrome-trace categories of the work the device itself does
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
TRACE_SUFFIX = ".pt.trace.json"


def _sync_cuda() -> None:
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


class PhaseTimers:
    """Accumulating named wall-clock timers.

    >>> timers = PhaseTimers()
    >>> with timers.phase("filter"):
    ...     run_filter()
    >>> timers.report()
    """

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            _sync_cuda()
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> Dict[str, Dict[str, float]]:
        return {
            name: {
                "total_s": self.totals[name],
                "calls": self.counts[name],
                "mean_s": self.totals[name] / self.counts[name],
            }
            for name in self.totals
        }

    def log(self) -> None:
        for name, r in self.report().items():
            logger.info(
                "phase %-16s total=%.3fs calls=%d mean=%.4fs",
                name, r["total_s"], r["calls"], r["mean_s"],
            )


@contextlib.contextmanager
def trace(log_dir: str):
    """``torch.profiler`` over the block, with the CPU and, where there is
    one, the CUDA device; the device is synchronized before the profiler
    stops, and the Chrome trace is written to ``log_dir`` as
    ``<ns>.pt.trace.json`` (read it with `op_profile_summary`).  Yields the
    profiler."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        try:
            yield prof
        finally:
            _sync_cuda()
    prof.export_chrome_trace(
        os.path.join(log_dir, f"{time.time_ns():020d}{TRACE_SUFFIX}"))


# what `span` returns while no profiler records: one shared, reusable no-op
NO_SPAN = contextlib.nullcontext()

# the recorder of a step's capture into CUDA graphs while one runs
# (`models.graphs`), else None: it cuts the capture at every span
_capture = None


def span(name: str):
    """A context manager naming the block ``name`` in a trace.

    While a ``torch.profiler`` session records, it is
    ``torch.profiler.record_function(name)``: a ``user_annotation`` event on
    the host thread, in the same Chrome trace and on the same clock as the
    device's kernels and copies, so a launch inside the block can be traced
    back to it.  Otherwise it is `NO_SPAN`, and entering it costs a check
    of the profiler's state (``record_function`` itself costs microseconds
    with no profiler running).  The program's spans are named ``nbls.*``,
    one per layer boundary of a call; none is put inside a loop finer than
    the window-length buckets: ``nbls.api`` a call, around ``nbls.api.plan``
    (``nbls.pipeline.build`` on a cache miss), ``nbls.step`` (``nbls.h2d``,
    ``nbls.filter``, per bucket ``nbls.windows``, ``nbls.spectra`` and
    ``nbls.lag_search``, ``nbls.solve``; ``nbls.graph.capture`` /
    ``nbls.graph.replay``), ``nbls.package`` (``nbls.freqz``, ``nbls.d2h``)
    and, with LTS, ``nbls.stdict`` (the host's flag dictionary, after the
    package).

    While a step is captured into CUDA graphs (`capturing`), the
    recorder's span comes first: entering and leaving it also ends one
    graph and begins the next, so that a replay launches each graph inside
    the span that launched its work.  With no capture running that costs
    one test of None.
    """
    if _capture is not None:
        return _capture.span(name)
    return tracing_span(name)


def tracing_span(name: str):
    """`span` as the profiler alone decides it: ``record_function(name)``
    while a profiler records, `NO_SPAN` otherwise."""
    if not torch.autograd._profiler_enabled():
        return NO_SPAN
    return torch.profiler.record_function(name)


@contextlib.contextmanager
def capturing(recorder):
    """`span` defers to ``recorder`` (its ``span(name)``) inside the block."""
    global _capture
    if _capture is not None:
        raise RuntimeError("a capture is already running")
    _capture = recorder
    try:
        yield recorder
    finally:
        _capture = None


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


def op_profile_summary(trace_dir: str) -> Dict:
    """Device time of the newest trace `trace` wrote into ``trace_dir``.

    ``device_busy_s`` is the summed duration of the kernel, memcpy and
    memset events; ``kernels`` lists them by name, largest first, as
    ``{"name", "total_s", "calls"}``.  Raises RuntimeError when the
    directory holds no trace.
    """
    files = sorted(glob.glob(os.path.join(trace_dir, "*" + TRACE_SUFFIX)))
    if not files:
        raise RuntimeError(f"no trace under {trace_dir}")
    with open(files[-1]) as f:
        events = json.load(f).get("traceEvents", [])
    rows = device_rows(events)
    return {
        "device_busy_s": sum(r[0] for r in rows) * 1e-6,
        "kernels": [{"name": name, "total_s": us * 1e-6, "calls": n}
                    for us, name, n in rows],
    }


def device_name(device) -> str:
    """What `RunSummary.device` holds: the CUDA device's name, or "cpu"."""
    dev = torch.device(device)
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


@dataclass
class RunSummary:
    """Structured per-run record for logging/monitoring.  ``device`` is
    `device_name` of the device the run used."""

    workload: str
    nbands: int
    num_compute_list: List[int]
    nchans: int
    alpha: float
    device: str
    wall_s: float
    phases: Dict[str, Dict[str, float]] = field(default_factory=dict)

    @property
    def total_solves(self) -> int:
        return int(sum(self.num_compute_list))

    @property
    def solves_per_s(self) -> float:
        return self.total_solves / self.wall_s if self.wall_s > 0 else 0.0

    def to_json(self) -> str:
        d = dict(self.__dict__)
        d["total_solves"] = self.total_solves
        d["solves_per_s"] = self.solves_per_s
        return json.dumps(d)

    def log(self) -> None:
        logger.info("run summary: %s", self.to_json())
