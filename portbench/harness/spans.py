"""The program's spans in a traced window, and the device's work mapped to
them.

``narrow_band_least_squares_tpu_torch`` names each layer of a call with a
``torch.profiler.record_function`` range while a profiler records
(``utils/profiling.py::span``): ``nbls.api`` a call, around
``nbls.api.plan``, ``nbls.step`` (``nbls.h2d``, ``nbls.filter``, per
bucket ``nbls.windows``, ``nbls.spectra`` and ``nbls.lag_search``,
``nbls.solve``) and ``nbls.package`` (``nbls.freqz``, ``nbls.d2h``).  They
are ``user_annotation`` events of the Chrome trace, on the host thread
that ran them and on the device events' clock.

- A span's self time is its duration less the parts its child spans cover
  (spans nest on one host thread).
- A device operation belongs to the innermost span containing the start of
  its launch: the ``cuda_runtime`` or ``cuda_driver`` event with the same
  ``args.correlation``.  An operation launched outside every span belongs
  to none.
- A call counts where its ``nbls.api`` span lies wholly inside the window.

A trace without such spans (a program that records none) reads as empty:
every reader returns None.  So does a trace without device operations: on
the CPU the step runs as it is dispatched, and a span's time is the
computation itself, not the host's share of it.
"""

from __future__ import annotations

from bisect import bisect_right
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

PREFIX = "nbls."
CALL = "nbls.api"
LAUNCH_CATEGORIES = ("cuda_runtime", "cuda_driver")


@dataclass(eq=False)
class Span:
    name: str
    ts: float
    end: float
    parent: Optional["Span"] = None
    child_us: float = 0.0

    @property
    def dur(self) -> float:
        return self.end - self.ts

    @property
    def self_us(self) -> float:
        return self.dur - self.child_us

    @property
    def call(self) -> Optional["Span"]:
        s = self
        while s is not None and s.name != CALL:
            s = s.parent
        return s


def _correlation(e: dict):
    return (e.get("args") or {}).get("correlation")


def _link(spans: Sequence[Span]) -> None:
    """Links each of one thread's ``spans`` (ascending by start, parents
    first) to the span enclosing it, and adds its duration to that
    parent's ``child_us``."""
    stack: List[Span] = []
    for s in spans:
        while stack and stack[-1].end <= s.ts:
            stack.pop()
        if stack:
            s.parent = stack[-1]
            s.parent.child_us += min(s.end, s.parent.end) - s.ts
        stack.append(s)


def _innermost(spans: Sequence[Span], starts: Sequence[float], t: float) -> Optional[Span]:
    """The innermost of the linked ``spans`` (their ``starts`` ascending)
    that contains ``t``."""
    i = bisect_right(starts, t)
    s = spans[i - 1] if i else None
    while s is not None and s.end <= t:
        s = s.parent
    return s


class Spans:
    """The ``nbls.*`` spans of a `trace.Trace` and the owner of each of its
    device operations (``owner[i]`` for ``trace.device[i]``)."""

    def __init__(self, trace):
        self.trace = trace
        by_thread: Dict[tuple, List[Span]] = {}
        for e in trace.events if trace.device else ():
            if (e.get("ph") == "X" and str(e.get("cat", "")).lower() == "user_annotation"
                    and str(e.get("name", "")).startswith(PREFIX)):
                ts = float(e["ts"])
                key = (e.get("pid"), e.get("tid"))
                by_thread.setdefault(key, []).append(
                    Span(e["name"], ts, ts + float(e.get("dur", 0.0))))
        starts: Dict[tuple, List[float]] = {}
        for key, spans in by_thread.items():
            spans.sort(key=lambda s: (s.ts, -s.end))
            _link(spans)
            starts[key] = [s.ts for s in spans]
        self.spans = sorted((s for v in by_thread.values() for s in v), key=lambda s: s.ts)

        wanted = {_correlation(e) for e in trace.device} - {None}
        owner_of: Dict[object, Optional[Span]] = {}
        for e in trace.events:
            c = _correlation(e)
            if (c in wanted and c not in owner_of and e.get("ph") == "X"
                    and str(e.get("cat", "")).lower() in LAUNCH_CATEGORIES):
                key = (e.get("pid"), e.get("tid"))
                owner_of[c] = (_innermost(by_thread[key], starts[key], float(e["ts"]))
                               if key in by_thread else None)
        self.owner: List[Optional[Span]] = [owner_of.get(_correlation(e))
                                             for e in trace.device]

    # ---- calls -------------------------------------------------------
    def calls(self) -> List[Span]:
        """The ``nbls.api`` spans wholly inside the traced window."""
        t0, t1 = self.trace.t0, self.trace.t1
        return [s for s in self.spans if s.name == CALL and s.ts >= t0 and s.end <= t1]

    def per_call_ms(self, name: str) -> Optional[float]:
        """The mean over the window's calls of the summed duration of the
        spans ``name`` of each call."""
        calls = self.calls()
        ids = {id(c) for c in calls}
        mine = [s for s in self.spans if s.name == name and id(s.call) in ids]
        if not mine:
            return None
        return sum(s.dur for s in mine) * 1e-3 / len(calls)

    def api_host_ms(self) -> Optional[float]:
        """The mean over the window's calls of ``nbls.api``'s time outside
        its ``nbls.step`` and ``nbls.package`` children."""
        calls = self.calls()
        if not calls:
            return None
        own = {id(c): c.dur for c in calls}
        for s in self.spans:
            if s.name in ("nbls.step", "nbls.package") and s.parent is not None \
                    and id(s.parent) in own:
                own[id(s.parent)] -= s.dur
        return sum(own.values()) * 1e-3 / len(calls)

    # ---- the device --------------------------------------------------
    def device_us(self) -> Dict[Optional[str], float]:
        """Device microseconds of the window's operations by the name of
        the span that launched them (None: launched outside every span)."""
        out: Dict[Optional[str], float] = {}
        for e, s in zip(self.trace.device, self.owner):
            name = s.name if s is not None else None
            out[name] = out.get(name, 0.0) + float(e.get("dur", 0.0))
        return out

    def device_ms_per_segment(self, name: str, segments: int) -> Optional[float]:
        us = self.device_us().get(name)
        if not us or segments <= 0:
            return None
        return us * 1e-3 / segments


def of(trace) -> Spans:
    """The trace's `Spans`, built once a trace."""
    if getattr(trace, "_spans", None) is None:
        trace._spans = Spans(trace)
    return trace._spans
