"""PyTorch port: the LTS deployment of the benchmark's cell
``i53.lts_archive`` (``portbench/configs/i53_example_lts.json``: the
upstream example at ALPHA 0.75, element 3 incoherent) at a small size on
the CPU.

The API (``api.narrow_band_least_squares``, ``device="cpu"``) on the cell's
own traffic generator, cut to 3 log bands of 300 s segments, is held to the
benchmark's float64 reference (``portbench/reference/batched.py``) by the
benchmark's own check (``portbench/harness/check.py::Tally``) under the
configuration's ``guarantee``, and no window's flagged elements may differ
from the reference's dropped pairs.  At ALPHA 1 the same holds OLS.  Under
a CPU ``torch.profiler`` an LTS call records one ``nbls.stdict`` span (the
host's flag dictionary), inside ``nbls.api`` and outside the step and the
package, an OLS call none, and the dictionary is the same with the
profiler as without (on 2 bands of 120 s segments).
"""

import collections
import json
from pathlib import Path

import numpy as np
import pytest
from torch.profiler import ProfilerActivity, profile

from narrow_band_least_squares_tpu_torch import api
from narrow_band_least_squares_tpu_torch.io.stream import ArrayStream
from portbench.harness.check import Tally
from portbench.harness.traffic import Traffic
from portbench.reference.batched import Deployment, solve_segment
from portbench.reference.geometry import get_rij
from portbench.reference.timeutils import stdict_timestamp_key

ROOT = Path(__file__).resolve().parents[1]
CFG = json.loads((ROOT / "portbench/configs/i53_example_lts.json").read_text())
TRAFFIC = json.loads((ROOT / "portbench/traffic/archive_outlier.json").read_text())
# the cell cut to 3 bands of 300 s segments; one segment a seed
SMALL = dict(CFG, NBANDS=3, SEGMENT_S=300.0)
SEEDS = [2 ** 31 + 101, 2 ** 31 + 102, 2 ** 31 + 103]
# the span tests only count spans: 2 bands of 120 s segments
TINY = dict(CFG, NBANDS=2, SEGMENT_S=120.0)


def segment(seed, cfg=SMALL):
    """The cell's first segment of ``seed``, as its traffic makes it."""
    traffic = Traffic(cfg, dict(TRAFFIC, pool_segments=1), seed)
    st = ArrayStream(data=traffic.segment(0), fs=float(cfg["FS"]),
                     start_epoch=traffic.segment_epoch(0), latitudes=list(traffic.lats),
                     longitudes=list(traffic.lons))
    return traffic, st


def call(st, alpha, cfg=SMALL):
    """``api.narrow_band_least_squares`` with the arguments of the cell's
    entry point (``portbench/entries/api.py``)."""
    freqlist, nbands, _ = api.get_freqlist(cfg["FMIN"], cfg["FMAX"], cfg["FREQ_BAND_TYPE"],
                                           cfg["NBANDS"])
    winlens = api.get_winlenlist(cfg["WINDOW_LENGTH_TYPE"], nbands, cfg["WINLEN"],
                                 cfg["WINLEN_1"], cfg["WINLEN_X"])
    freq_resp = np.logspace(np.log10(0.01), np.log10(cfg["FS"] / 2),
                            num=int(TRAFFIC["freq_resp_points"]))
    return api.narrow_band_least_squares(
        winlens, cfg["WINOVER"], alpha, st, st.latitudes, st.longitudes, nbands, None, None,
        freqlist, cfg["FREQ_BAND_TYPE"], freq_resp, cfg["FILTER_TYPE"], cfg["FILTER_ORDER"],
        cfg["FILTER_RIPPLE"], device="cpu")


def answer(out):
    """The 9-tuple as the check reads an answer: per band and valid window
    the sorted 1-based elements of the window's ``stdict`` entry."""
    vel, baz, mdccm, t, stdict, sig_tau, ncl = out[:7]
    ans = {"vel": vel, "baz": baz, "mdccm": mdccm, "t": t, "sig_tau": sig_tau,
           "num_compute": list(ncl)}
    if stdict is not None:
        ans["size"] = stdict["size"]
        ans["elements"] = [
            [None if (e := stdict.get(f"{b + 1:02d}_" + stdict_timestamp_key(t[b, w]))) is None
             else sorted(int(x) for x in e) for w in range(n)]
            for b, n in enumerate(ncl)]
    return ans


def dropped_elements(ref_band):
    """Per window, the sorted 1-based elements of the reference's dropped
    pairs (each pair gives both of its elements)."""
    pairs = ref_band["pairs"]
    return [sorted(int(e) + 1 for p in np.flatnonzero(row) for e in pairs[p])
            for row in ref_band["flags"]]


@pytest.mark.parametrize("alpha, seed", [(0.75, s) for s in SEEDS] + [(1.0, SEEDS[0])],
                         ids=lambda v: str(v))
def test_port_holds_the_cells_limits(alpha, seed):
    cfg = dict(SMALL, ALPHA=alpha)
    traffic, st = segment(seed, cfg)
    ans = answer(call(st, alpha, cfg))
    dep = Deployment(cfg, traffic.npts)
    rij = get_rij(traffic.lats, traffic.lons, len(traffic.lats))
    ref = solve_segment(dep, rij, traffic.segment(0), traffic.segment_epoch(0))
    tally = Tally(CFG["guarantee"], traffic.fs)
    tally.add("segment 0", ans, ref)
    assert tally.correct(), (tally.numbers(), tally.notes)
    assert tally.windows == sum(dep.num_compute_list) > 30
    if alpha < 1.0:
        assert ans["size"] == 8
        for b, r in enumerate(ref):
            assert ans["elements"][b] == dropped_elements(r), b
        # the incoherent element is flagged where the wave is coherent
        flagged = collections.Counter(e for band in ans["elements"] for w in band for e in w)
        assert flagged.most_common(1)[0][0] == 3
    else:
        assert "elements" not in ans and all("flags" not in r for r in ref)


def _spans(prof):
    return [e for e in prof.profiler.function_events if e.name.startswith("nbls.")]


def _enclosing(e):
    """The names of the ``nbls.*`` spans enclosing ``e``, innermost first."""
    out, q = [], e.cpu_parent
    while q is not None:
        if q.name.startswith("nbls."):
            out.append(q.name)
        q = q.cpu_parent
    return out


@pytest.fixture(scope="module")
def lts_segment():
    return segment(SEEDS[0], TINY)[1]


@pytest.mark.parametrize("entry", ["api", "ltsva"])
def test_an_lts_call_records_one_stdict_span(lts_segment, entry):
    st = lts_segment

    def lts():
        if entry == "api":
            return call(st, 0.75, TINY)[4]
        return api.ltsva(st, st.latitudes, st.longitudes, 60.0, 0.5, 0.75, device="cpu")[4]

    lts()                                            # builds the pipeline outside
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        first, second = lts(), lts()
        ols = call(st, 1.0, TINY)
    assert first is not None and second is not None and ols[4] is None
    spans = _spans(prof)
    calls = [e for e in spans if e.name == "nbls.api"]
    stdicts = [e for e in spans if e.name == "nbls.stdict"]
    assert len(calls) == 3 and len(stdicts) == 2
    for e in stdicts:
        enclosing = _enclosing(e)
        assert enclosing[-1] == "nbls.api"
        assert not {"nbls.step", "nbls.package"} & set(enclosing)
    assert not [e for e in spans if "nbls.stdict" in _enclosing(e)]
    # one a call, in the two LTS calls; none in the OLS call, the last
    owners = {id(c) for e in stdicts for c in calls
              if c.time_range.start <= e.time_range.start <= e.time_range.end
              <= c.time_range.end}
    assert owners == {id(c) for c in sorted(calls, key=lambda c: c.time_range.start)[:2]}


def test_the_stdict_is_the_same_under_the_profiler(lts_segment):
    plain = call(lts_segment, 0.75, TINY)[4]
    with profile(activities=[ProfilerActivity.CPU]):
        traced = call(lts_segment, 0.75, TINY)[4]
    assert list(plain) == list(traced)
    assert plain["size"] == traced["size"] == 8
    for key in plain:
        if key == "size":
            continue
        assert plain[key].dtype == traced[key].dtype == np.int64
        assert np.array_equal(plain[key], traced[key]), key
    assert sum(len(v) for k, v in plain.items() if k != "size") > 0
