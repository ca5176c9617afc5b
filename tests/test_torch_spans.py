"""PyTorch port: the program's spans (`utils.profiling.span`).

Under ``torch.profiler`` every call of the API names its layers: one
``nbls.api`` a call, enclosing the plan lookup, the step (host-to-device
copy, filter bank, per window-length bucket the window extraction, the
spectra and the lag search, the solve) and the packaging (the filters'
frequency responses, the device-to-host copies); ``nbls.pipeline.build``
only where a call builds its pipeline.  With no profiler recording,
`span` is one shared no-op.
"""

import collections

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from narrow_band_least_squares_tpu_torch import api
from narrow_band_least_squares_tpu_torch.io import synthetic_plane_wave
from narrow_band_least_squares_tpu_torch.models import NarrowBandPipeline
from narrow_band_least_squares_tpu_torch.utils import profiling as P

# each span's enclosing span; the spans that come once a bucket
PARENT = {
    "nbls.api": None,
    "nbls.api.plan": "nbls.api",
    "nbls.pipeline.build": "nbls.api.plan",
    "nbls.step": "nbls.api",
    "nbls.h2d": "nbls.step",
    "nbls.filter": "nbls.step",
    "nbls.windows": "nbls.step",
    "nbls.spectra": "nbls.step",
    "nbls.lag_search": "nbls.step",
    "nbls.solve": "nbls.step",
    "nbls.package": "nbls.api",
    "nbls.freqz": "nbls.package",
    "nbls.d2h": "nbls.package",
}
PER_BUCKET = {"nbls.windows", "nbls.spectra", "nbls.lag_search"}
# 'fused' extracts the windows and forms the spectra inside its lag search
ROUTE_SPANS = {"mxu": set(PARENT), "fused": set(PARENT) - {"nbls.windows", "nbls.spectra"}}


@pytest.fixture(scope="module")
def small():
    st = synthetic_plane_wave(nchans=4, duration_s=120, fs=10.0, baz_deg=230.0,
                              trace_vel_kms=0.34, f0=0.6, bandwidth=0.8, snr=8, seed=7)
    freqlist, nbands, _ = api.get_freqlist(0.3, 1.5, "log", 3)
    winlens = api.get_winlenlist("adaptive", nbands, 0, 40, 20)
    return st, freqlist, nbands, winlens


def _call(small):
    st, freqlist, nbands, winlens = small
    return api.narrow_band_least_squares(
        winlens, 0.5, 1.0, st, st.latitudes, st.longitudes, nbands, None, None,
        freqlist, "log", np.logspace(-2, 0.7, 50), "cheby1", 2, 0.01, device="cpu")


def _spans(prof):
    return [e for e in prof.profiler.function_events if e.name.startswith("nbls.")]


def _span_parent(e):
    q = e.cpu_parent
    while q is not None and not q.name.startswith("nbls."):
        q = q.cpu_parent
    return q


def _call_of(e):
    while e is not None and e.name != "nbls.api":
        e = _span_parent(e)
    return e


def _buckets(small):
    st, freqlist, nbands, winlens = small
    plan = api.make_plan(freqlist, "log", winlens, 0.5, st.npts, st.fs)
    rij = api.get_rij(list(st.latitudes), list(st.longitudes), st.nchans)
    return len(api._get_pipeline(plan, rij, device="cpu")._buckets)


@pytest.mark.parametrize("method", ["mxu", "fused"])
def test_every_call_names_its_layers(small, method):
    prev = api.set_performance_defaults(xcorr_method=method)   # empties the cache
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            first, second = _call(small), _call(small)
        buckets = _buckets(small)
    finally:
        api.set_performance_defaults(**{"xcorr_method": None, **prev})
    assert len(first) == len(second) == 9
    spans = _spans(prof)
    calls = sorted((e for e in spans if e.name == "nbls.api"),
                   key=lambda e: e.time_range.start)
    assert len(calls) == 2
    by_call = collections.defaultdict(collections.Counter)
    for e in spans:
        parent = _span_parent(e)
        assert (parent.name if parent is not None else None) == PARENT[e.name], e.name
        call = _call_of(e)
        assert call is not None
        by_call[calls.index(call)][e.name] += 1
    assert buckets >= 2
    for k in (0, 1):
        want = {name: buckets if name in PER_BUCKET else 1
                for name in ROUTE_SPANS[method]}
        if k == 1:
            del want["nbls.pipeline.build"]     # built by the first call only
        assert dict(by_call[k]) == want
    assert by_call[0]["nbls.lag_search"] == by_call[1]["nbls.lag_search"] == buckets


def test_spans_nest_inside_their_call(small):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _call(small)
    spans = _spans(prof)
    (call,) = [e for e in spans if e.name == "nbls.api"]
    for e in spans:
        parent = _span_parent(e) or e
        assert parent.time_range.start <= e.time_range.start
        assert e.time_range.end <= parent.time_range.end
        assert call.time_range.start <= e.time_range.start <= e.time_range.end \
            <= call.time_range.end


def test_ltsva_and_run_raw_name_their_layers(small):
    st = small[0]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        api.ltsva(st, st.latitudes, st.longitudes, 40.0, 0.5, device="cpu")
    names = collections.Counter(e.name for e in _spans(prof))
    # a pre-filtered stream: no filter bank, so no frequency responses
    assert names["nbls.api"] == names["nbls.step"] == names["nbls.package"] == 1
    assert names["nbls.d2h"] == 1 and names["nbls.freqz"] == 0
    assert names["nbls.lag_search"] >= 1

    _, freqlist, nbands, winlens = small
    plan = api.make_plan(freqlist, "log", winlens, 0.5, st.npts, st.fs)
    rij = api.get_rij(list(st.latitudes), list(st.longitudes), st.nchans)
    pipe = api._get_pipeline(plan, rij, device="cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        pipe.run_raw(st.data)
    names = collections.Counter(e.name for e in _spans(prof))
    assert names["nbls.step"] == names["nbls.h2d"] == names["nbls.filter"] == 1
    assert names["nbls.api"] == names["nbls.package"] == 0


@pytest.mark.parametrize("kw", [{}, {"xcorr_method": "pallas"}, {"bucket_bands": False},
                                {"subsample_delays": True}],
                         ids=["mxu", "pallas", "unbucketed", "subsample"])
def test_nothing_runs_between_a_buckets_windows_and_its_spectra(small, kw):
    """Each band's lag bounds are built once, at `load_state`
    (`ops.xcorr.lag_tables`): a step runs no operation between a bucket's
    ``nbls.windows`` and its ``nbls.spectra``, where the capture on the card
    would cut an empty graph."""
    st, freqlist, nbands, winlens = small
    plan = api.make_plan(freqlist, "log", winlens, 0.5, st.npts, st.fs)
    rij = api.get_rij(list(st.latitudes), list(st.longitudes), st.nchans)
    pipe = NarrowBandPipeline(plan, rij, device="cpu", **kw)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        pipe.run_raw(st.data)
    events = prof.profiler.function_events
    windows, spectra = ([e for e in events if e.name == name]
                        for name in ("nbls.windows", "nbls.spectra"))
    assert len(windows) == len(spectra) == (len(pipe._buckets) or 1)
    ops = [e for e in events if e.name.startswith("aten::")]
    assert ops
    for w, s in zip(*(sorted(v, key=lambda e: e.time_range.start)
                      for v in (windows, spectra))):
        assert w.time_range.end <= s.time_range.start
        between = [e.name for e in ops if w.time_range.end <= e.time_range.start
                   and e.time_range.end <= s.time_range.start]
        assert between == []


def test_span_is_a_shared_no_op_without_a_profiler(small):
    assert not torch.autograd._profiler_enabled()
    assert P.span("nbls.api") is P.span("nbls.step") is P.NO_SPAN
    with P.span("nbls.api"):
        with P.span("nbls.step"):     # nests, and enters again
            pass
    _call(small)                      # nothing records, nothing fails
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        inside = P.span("nbls.api")
        assert inside is not P.NO_SPAN
        with inside:
            pass
    assert [e.name for e in _spans(prof)] == ["nbls.api"]
    assert P.span("nbls.api") is P.NO_SPAN
