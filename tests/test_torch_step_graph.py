"""PyTorch port: `run`'s step captured as CUDA graphs cut at its spans
(`models/graphs.py`, `NarrowBandPipeline._run_step`).

The CPU has no CUDA graphs, so these tests drive the recorder and the
replay through a fake backend: a "graph" is the list of work notes made
while it was open, and a replay logs it.  Whether a replay computes the
eager step's bits is the card's check (``chip_smoke.py --phases graph``).
"""

import logging

import numpy as np
import pytest
import torch

from narrow_band_least_squares_tpu_torch import api
from narrow_band_least_squares_tpu_torch.io import synthetic_plane_wave
from narrow_band_least_squares_tpu_torch.models import narrowband as NB
from narrow_band_least_squares_tpu_torch.models.graphs import (
    ENTER, EXIT, GRAPH, StepGraphs,
)
from narrow_band_least_squares_tpu_torch.utils import profiling as P


class FakeGraphs:
    """The backend's interface on the CPU.  ``end`` keeps a graph with at
    least one note (``every=True``: every graph); ``fail_begin`` makes the
    n-th ``begin`` raise."""

    def __init__(self, every=False, fail_begin=None):
        self.every, self.fail_begin = every, fail_begin
        self.open, self.begun, self.aborted = None, 0, 0
        self.log = []          # what replays launched

    def capturing(self):
        return P.NO_SPAN

    def begin(self):
        self.begun += 1
        if self.begun == self.fail_begin:
            raise RuntimeError("operation not permitted when stream is capturing")
        self.open = []
        return self.open

    def end(self, g):
        self.open = None
        return self.every or bool(g)

    def abort(self, g):
        self.open = None
        self.aborted += 1

    def replay(self, g):
        self.log.append(("graph", tuple(g)))

    def work(self, name):
        if self.open is not None:
            self.open.append(name)


@pytest.fixture
def counters():
    for k in ("graph_captures", "graph_replays", "eager_steps", "graph_fallbacks"):
        setattr(NB, k, 0)
    return lambda: {k: getattr(NB, k) for k in
                    ("graph_captures", "graph_replays", "eager_steps", "graph_fallbacks")}


@pytest.fixture
def logged_spans(monkeypatch):
    """Logs every span entered and left (the profiler's side of `span`)."""
    log = []

    class Logged:
        def __init__(self, name):
            self.name = name

        def __enter__(self):
            log.append(("enter", self.name))

        def __exit__(self, *exc):
            log.append(("exit", self.name))

    monkeypatch.setattr(P, "tracing_span", Logged)
    return log


def fake_step(backend):
    def step(x):
        backend.work("a")
        with P.span("s1"):
            backend.work("b")
            with P.span("s2"):
                backend.work("c")
        with P.span("s3"):
            pass                        # a span with no device work
        backend.work("d")
        return {"y": x + 1}
    return step


def test_the_recorder_cuts_a_step_at_its_spans():
    backend = FakeGraphs()
    g = StepGraphs(backend, fake_step(backend), torch.zeros(2))
    program = [(op, tuple(arg) if op == GRAPH else arg) for op, arg in g.program]
    assert program == [
        (GRAPH, ("a",)), (ENTER, "s1"), (GRAPH, ("b",)), (ENTER, "s2"), (GRAPH, ("c",)),
        (EXIT, None), (EXIT, None), (ENTER, "s3"), (EXIT, None), (GRAPH, ("d",))]
    assert g.graphs == 4
    assert torch.equal(g.outputs["y"], torch.ones(2))
    assert P._capture is None


def test_empty_segments_are_dropped():
    backend = FakeGraphs(every=True)
    every = StepGraphs(backend, fake_step(backend), torch.zeros(2))
    backend = FakeGraphs()
    kept = StepGraphs(backend, fake_step(backend), torch.zeros(2))
    # six cuts (each span's entry and exit) make seven graphs, three empty
    assert every.graphs == 7
    assert kept.graphs == 4
    assert [arg for op, arg in every.program if op != GRAPH] == \
        [arg for op, arg in kept.program if op != GRAPH]


def test_every_graph_lives_as_long_as_the_capture():
    import gc
    import weakref

    class Graph(list):
        pass

    class Held(FakeGraphs):
        def begin(self):
            self.open = Graph()
            return self.open

    backend = Held()
    g = StepGraphs(backend, fake_step(backend), torch.zeros(2))
    refs = [weakref.ref(x) for x in g._begun]
    assert len(refs) == 7 and g.graphs == 4
    gc.collect()
    assert all(r() is not None for r in refs)    # the three empty ones too
    del g
    gc.collect()
    assert all(r() is None for r in refs)


def test_a_replay_reenters_the_spans_in_order(logged_spans):
    backend = FakeGraphs()
    step = fake_step(backend)
    g = StepGraphs(backend, step, torch.zeros(2))
    captured = list(logged_spans)
    del logged_spans[:]
    backend.log = logged_spans          # one log for graphs and spans
    g.replay()
    assert logged_spans == [
        ("graph", ("a",)), ("enter", "s1"), ("graph", ("b",)), ("enter", "s2"),
        ("graph", ("c",)), ("exit", "s2"), ("exit", "s1"), ("enter", "s3"),
        ("exit", "s3"), ("graph", ("d",))]
    # the capture named the same spans as it went
    assert captured == [e for e in logged_spans if e[0] != "graph"]


def test_a_replay_leaves_no_span_open_when_it_fails(logged_spans):
    backend = FakeGraphs()
    g = StepGraphs(backend, fake_step(backend), torch.zeros(2))
    del logged_spans[:]

    def broken(graph):
        if graph == ["c"]:
            raise RuntimeError("replay failed")
    backend.replay = broken
    with pytest.raises(RuntimeError):
        g.replay()
    assert logged_spans == [("enter", "s1"), ("enter", "s2"), ("exit", "s2"),
                            ("exit", "s1")]


def test_a_failed_capture_leaves_nothing_capturing():
    backend = FakeGraphs(fail_begin=3)      # at s2's entry
    with pytest.raises(RuntimeError):
        StepGraphs(backend, fake_step(backend), torch.zeros(2))
    assert P._capture is None
    assert backend.open is None
    with pytest.raises(RuntimeError):       # one capture at a time
        with P.capturing(object()):
            with P.capturing(object()):
                pass
    assert P._capture is None


def test_spans_of_other_threads_do_not_cut(logged_spans):
    import threading

    backend = FakeGraphs()
    names, threads = [], []

    def step(x):
        backend.work("a")
        t = threading.Thread(target=lambda: names.append(type(P.span("other")).__name__))
        threads.append(t)
        t.start()
        t.join(timeout=10)
        backend.work("b")
        return {"y": x}

    g = StepGraphs(backend, step, torch.zeros(1))
    assert not threads[0].is_alive()
    assert [tuple(arg) for op, arg in g.program] == [("a", "b")]
    assert names == ["Logged"]              # the profiler's span, not a cut


# ---- the pipeline ----------------------------------------------------------

@pytest.fixture(scope="module")
def small():
    st = synthetic_plane_wave(nchans=4, duration_s=120, fs=10.0, baz_deg=230.0,
                              trace_vel_kms=0.34, f0=0.6, bandwidth=0.8, snr=8, seed=7)
    freqlist, nbands, _ = api.get_freqlist(0.3, 1.5, "log", 3)
    winlens = api.get_winlenlist("adaptive", nbands, 0, 40, 20)
    plan = api.make_plan(freqlist, "log", winlens, 0.5, st.npts, st.fs)
    rij = api.get_rij(list(st.latitudes), list(st.longitudes), st.nchans)
    return st, plan, rij


def _pipe(small, **kw):
    st, plan, rij = small
    return NB.NarrowBandPipeline(plan, rij, device="cpu", **kw)


def _same(a, b):
    for k in ("vel_array", "baz_array", "mdccm_array", "sig_tau_array",
              "vel_uncert_array", "baz_uncert_array", "flags"):
        x, y = getattr(a, k), getattr(b, k)
        assert (x is None) == (y is None), k
        if x is not None:
            np.testing.assert_array_equal(x, y, err_msg=k)


def test_run_stays_eager_on_the_cpu(small, counters):
    st = small[0]
    pipe = _pipe(small)
    assert pipe._graph_backend is None
    first, second, third = (pipe.run(st) for _ in range(3))
    assert counters() == {"graph_captures": 0, "graph_replays": 0, "eager_steps": 3,
                          "graph_fallbacks": 0}
    assert pipe._graphs is None and pipe._x_static is None
    _same(first, third)


@pytest.mark.parametrize("kw", [{}, {"xcorr_method": "fused"}, {"alpha": 0.75},
                                {"window_method": "gather"}])
def test_the_second_run_captures_and_later_runs_replay(small, counters, logged_spans, kw):
    st = small[0]
    pipe = _pipe(small, **kw)
    pipe._graph_backend = FakeGraphs(every=True)
    eager = pipe.run(st)
    assert counters()["eager_steps"] == 1 and pipe._graphs is None
    del logged_spans[:]
    captured = pipe.run(st)              # captured, then replayed
    assert counters() == {"graph_captures": 1, "graph_replays": 1, "eager_steps": 1,
                          "graph_fallbacks": 0}
    _same(eager, captured)               # the CPU computes while it captures
    assert ("enter", "nbls.graph.capture") in logged_spans
    del logged_spans[:]
    pipe.run(st)
    assert counters()["graph_captures"] == 1 and counters()["graph_replays"] == 2
    # the replay launches every graph inside the spans an eager step enters
    stage = [e for e in logged_spans if e[1] not in
             ("nbls.step", "nbls.h2d", "nbls.graph.replay", "nbls.package",
              "nbls.freqz", "nbls.d2h")]
    del logged_spans[:]
    pipe.run_raw(st.data)
    eager_stage = [e for e in logged_spans if e[1] not in ("nbls.step", "nbls.h2d")]
    assert stage == eager_stage and len(stage) >= 4
    assert logged_spans[0] == ("enter", "nbls.step")
    assert pipe._graphs.graphs == sum(1 for op, _ in pipe._graphs.program if op == GRAPH)


def test_load_state_drops_the_graphs(small, counters):
    st = small[0]
    pipe = _pipe(small, xcorr_method="fused")
    pipe._graph_backend = FakeGraphs(every=True)
    pipe.run(st), pipe.run(st)
    assert pipe._graphs is not None
    pipe.load_state(pipe.state_dict())
    assert pipe._graphs is None
    assert set(pipe._fused_rows) == {(i, 1) for i in range(len(pipe._buckets))}
    pipe.run(st)                         # captures again at once
    assert counters()["graph_captures"] == 2 and counters()["eager_steps"] == 1


def test_run_raw_and_run_batch_raw_never_replay(small, counters):
    st = small[0]
    pipe = _pipe(small)
    backend = pipe._graph_backend = FakeGraphs(every=True)
    pipe.run(st), pipe.run(st)
    before, replays = counters(), len(backend.log)
    one = pipe.run_raw(st.data)
    batch = pipe.run_batch_raw(np.stack([st.data, st.data]))
    assert counters() == before and len(backend.log) == replays
    assert one["vel"] is not pipe._graphs.outputs["vel"]
    for k, v in one.items():
        assert torch.equal(batch[k][1], v)


def test_a_capture_that_raises_falls_back_once(small, counters, caplog):
    st = small[0]
    pipe = _pipe(small, alpha=0.75)
    pipe._graph_backend = FakeGraphs(fail_begin=4)
    eager = pipe.run(st)
    with caplog.at_level(logging.WARNING, logger="nbls_torch"):
        fell_back = pipe.run(st)
        again = pipe.run(st)
    assert counters() == {"graph_captures": 0, "graph_replays": 0, "eager_steps": 3,
                          "graph_fallbacks": 1}
    assert pipe._graph_backend.aborted == 0      # begin raised: nothing was open
    warned = [r for r in caplog.records if "CUDA graphs failed" in r.getMessage()]
    assert len(warned) == 1 and "RuntimeError" in warned[0].getMessage()
    _same(eager, fell_back)
    _same(eager, again)


def test_a_step_that_raises_inside_the_capture_falls_back(small, counters, monkeypatch):
    st = small[0]
    pipe = _pipe(small)
    backend = pipe._graph_backend = FakeGraphs(every=True)
    eager = pipe.run(st)
    real = pipe._solve_masked

    def host_read(*a, **kw):
        if P._capture is not None:
            raise RuntimeError("cudaErrorStreamCaptureUnsupported")
        return real(*a, **kw)
    monkeypatch.setattr(pipe, "_solve_masked", host_read)
    _same(eager, pipe.run(st))
    assert counters()["graph_fallbacks"] == 1 and backend.aborted == 1
    assert P._capture is None


def test_another_shape_runs_eagerly(small, counters):
    st = small[0]
    pipe = _pipe(small)
    pipe._graph_backend = FakeGraphs(every=True)
    pipe.run(st), pipe.run(st)
    pipe._step = lambda x: {"shape": tuple(x.shape)}
    assert pipe._run_step(st.data[:3]) == {"shape": (3, st.npts)}
    assert counters()["eager_steps"] == 2 and counters()["graph_replays"] == 1
    pipe._run_step(st.data)
    assert counters()["eager_steps"] == 2 and counters()["graph_replays"] == 2


def test_concurrent_runs_of_one_pipeline_capture_once(small, counters):
    import sys
    import threading

    st = small[0]
    pipe = _pipe(small)
    backend = pipe._graph_backend = FakeGraphs(every=True)
    want = pipe.run_raw(st.data)
    results, errors = [], []

    def worker():
        try:
            for _ in range(3):
                results.append(pipe.run(st))
        except Exception as e:        # reported below
            errors.append(e)

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
    finally:
        sys.setswitchinterval(switch)
    assert not errors and not any(t.is_alive() for t in threads)
    assert counters() == {"graph_captures": 1, "graph_replays": 23, "eager_steps": 1,
                          "graph_fallbacks": 0}
    assert len(results) == 24 and len(backend.log) == 23 * pipe._graphs.graphs
    W = want["vel"].shape[-1]
    for r in results:
        np.testing.assert_array_equal(r.vel_array[:, :W], want["vel"].double().numpy())
