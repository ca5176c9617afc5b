"""A pipeline's step captured as CUDA graphs, cut at the program's spans.

An eager step launches several hundred small device operations a call from
Python (kernels, cuBLAS and cuFFT calls, copies), and the host takes many
times the device's time to issue them.  `StepGraphs` captures the step's
device work once and replays it: the same operations in the same order on
the same buffers, issued a graph at a time.

The capture is cut at every `utils.profiling.span` that the step enters or
leaves (`Recorder`): each cut ends the graph being captured and begins the
next, all of them in one memory pool and in replay order.  What it records
is a program, "enter span, graph k, leave span, ...": `StepGraphs.replay`
walks it under the same spans, so each operation is launched inside the
same innermost span as in an eager step, and a trace attributes a graph's
work (by the correlation of the ``cudaGraphLaunch`` that replayed it) to
the span it belongs to.  A graph that captured no device work is dropped.

The graphs read the step's input where the capture read it and write its
outputs to the tensors the capture returned (`StepGraphs.outputs`): the
caller copies each new input into that buffer, and every replay
overwrites the outputs.  Nothing inside the step may read the host (a copy
from pageable memory, a synchronize): the capture raises there.

The backend (`CudaGraphs` on the card) is an object of its own so that
the CPU tests can drive the recorder and the replay with a fake one.
"""

from __future__ import annotations

import threading
import warnings
from contextlib import contextmanager
from typing import List, Tuple

import torch

from narrow_band_least_squares_tpu_torch.utils import profiling

# the steps of a captured program
ENTER, EXIT, GRAPH = "enter", "exit", "graph"


class CudaGraphs:
    """``torch.cuda.CUDAGraph`` captures on a side stream (a capture cannot
    run on the default stream), every graph of one step in one memory
    pool."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.pool = None

    @contextmanager
    def capturing(self):
        """The block runs on a side stream ordered after the current
        stream's work so far, and the current stream's later work after
        the block's; a new memory pool for the graphs it captures."""
        self.pool = torch.cuda.graph_pool_handle()
        current = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(current)
        try:
            with torch.cuda.stream(side):
                yield
        finally:
            current.wait_stream(side)

    def begin(self):
        g = torch.cuda.CUDAGraph()
        # what the capturing thread may not do raises there; other threads'
        # work goes on (only the capturing thread's calls are checked)
        g.capture_begin(pool=self.pool, capture_error_mode="thread_local")
        return g

    def end(self, g) -> bool:
        """Ends ``g``'s capture.  False where it holds no device work:
        PyTorch warns of an empty graph."""
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            g.capture_end()
        return not any("graph is empty" in str(w.message).lower() for w in seen)

    def abort(self, g) -> None:
        """Ends the capture of ``g`` after a failure; ``g`` is dropped."""
        try:
            g.capture_end()
        except RuntimeError:
            pass

    def replay(self, g) -> None:
        g.replay()


class Recorder:
    """Cuts a capture at the spans of the thread that captures
    (`utils.profiling.capturing`) and records the program."""

    def __init__(self, backend):
        self.backend = backend
        self.program: List[Tuple[str, object]] = []
        # every graph begun, the empty ones too: PyTorch releases a graph's
        # share of the pool when the graph is freed, and a pool that no
        # graph holds any more cannot take the next capture
        self.begun: List[object] = []
        self.graph = None
        self.thread = threading.get_ident()

    def begin(self) -> None:
        self.graph = self.backend.begin()
        self.begun.append(self.graph)

    def cut(self) -> None:
        """Ends the graph being captured; keeps it if it holds work."""
        g, self.graph = self.graph, None
        if self.backend.end(g):
            self.program.append((GRAPH, g))

    def abort(self) -> None:
        g, self.graph = self.graph, None
        if g is not None:
            self.backend.abort(g)

    def span(self, name: str):
        if threading.get_ident() != self.thread:
            return profiling.tracing_span(name)
        return _Cut(self, name)


class _Cut:
    """A span of the capturing thread: the graph before it ends at its
    entry, the one inside it at its exit (not after a failure, which
    `StepGraphs` aborts)."""

    def __init__(self, recorder: Recorder, name: str):
        self.recorder, self.name = recorder, name

    def __enter__(self):
        rec = self.recorder
        rec.cut()
        rec.program.append((ENTER, self.name))
        rec.begin()
        self.traced = profiling.tracing_span(self.name)
        self.traced.__enter__()
        return self

    def __exit__(self, *exc):
        rec = self.recorder
        try:
            if exc[0] is None:
                rec.cut()
            rec.program.append((EXIT, None))
        finally:
            self.traced.__exit__(*exc)
        if exc[0] is None:
            rec.begin()
        return False


class StepGraphs:
    """``step(x)`` captured as graphs cut at its spans (module docstring).

    Raises what the capture raised, with no capture left running."""

    def __init__(self, backend, step, x):
        rec = Recorder(backend)
        with backend.capturing(), profiling.capturing(rec):
            rec.begin()
            try:
                self.outputs = step(x)
                rec.cut()
            except BaseException:
                rec.abort()
                raise
        self.backend, self.program, self._begun = backend, rec.program, rec.begun

    @property
    def graphs(self) -> int:
        return sum(op == GRAPH for op, _ in self.program)

    def replay(self) -> None:
        """Launches the graphs in capture order, each inside the spans that
        held its work; the results land in `outputs`."""
        replay, entered = self.backend.replay, []
        try:
            for op, arg in self.program:
                if op == GRAPH:
                    replay(arg)
                elif op == ENTER:
                    s = profiling.span(arg)
                    s.__enter__()
                    entered.append(s)
                else:
                    entered.pop().__exit__(None, None, None)
        finally:
            while entered:
                entered.pop().__exit__(None, None, None)
