"""A configuration may hold a network of arrays (``"arrays"``): the harness
draws, hands over and checks every array's data apart, and a configuration
of one array (``"array"``) runs as it always did.

On the CPU, in a temporary checkout, a 2-array network cut as
`test_portbench_fp32_control.py` cuts its cell (3 third-octave bands from
``FMIN`` 2.5 Hz, 300 s segments, a pool of 2, both checked, 1 warm-up call);
the arrays are rings of 2.0 and 1.0 km apertures at different places.  Its
entry point, written here, answers each array with one
``api.narrow_band_least_squares`` call; the traffic's ``fault`` alters the
answers as a broken network entry would.  The pools of every accepted
cell's traffic are pinned by their SHA-256 at seeds 0 and 1, as the harness
made them before it knew of networks.
"""

import hashlib
import json
import re
import shutil

import numpy as np
import pytest

from conftest import ROOT, run_cell
from portbench.harness import check
from portbench.harness.spec import Spec, arrays_of
from portbench.harness.traffic import Traffic
from portbench.reference.synthetic import default_array_coords

SEED = 2 ** 31 + 281
ARRAYS = [{"name": "north", "lat0": 64.8738, "lon0": -147.8614, "aperture_km": 2.0},
          {"name": "south", "lat0": 63.9, "lon0": -145.7, "aperture_km": 1.0}]
FAULTS = ("none", "swap", "short", "one_none", "coords0")

NETWORK_ENTRY = '''
"""A test's network entry point: one api.narrow_band_least_squares call an
array a segment; the traffic's ``fault`` alters the answers."""

import numpy as np


class Entry:
    def __init__(self, cfg, params, traffic, device, options):
        from narrow_band_least_squares_tpu_torch import api
        from narrow_band_least_squares_tpu_torch.io.stream import ArrayStream

        self.api, self.ArrayStream = api, ArrayStream
        self.cfg, self.device, self.fault = cfg, device, params["fault"]
        self.coords = [(list(lats), list(lons)) for _, lats, lons in traffic.arrays]
        if self.fault == "coords0":
            self.coords = [self.coords[0]] * len(self.coords)
        self.freqlist, self.nbands, _ = api.get_freqlist(
            cfg["FMIN"], cfg["FMAX"], cfg["FREQ_BAND_TYPE"], cfg["NBANDS"])
        self.winlens = api.get_winlenlist(cfg["WINDOW_LENGTH_TYPE"], self.nbands,
                                          cfg["WINLEN"], cfg["WINLEN_1"], cfg["WINLEN_X"])
        self.freq_resp = np.logspace(np.log10(0.01), np.log10(float(cfg["FS"]) / 2),
                                     num=int(params["freq_resp_points"]))
        self.answers = {}

    def stream(self, call):
        return [self.ArrayStream(data=data, fs=float(self.cfg["FS"]),
                                 start_epoch=call.start_epoch, latitudes=lats, longitudes=lons)
                for data, (lats, lons) in zip(call.data, self.coords)]

    def __call__(self, streams):
        c = self.cfg
        self.last = [self.api.narrow_band_least_squares(
            self.winlens, c["WINOVER"], c["ALPHA"], st, st.latitudes, st.longitudes,
            self.nbands, None, None, self.freqlist, c["FREQ_BAND_TYPE"], self.freq_resp,
            c["FILTER_TYPE"], c["FILTER_ORDER"], c["FILTER_RIPPLE"], device=self.device)
            for st in streams]
        return 1

    def keep(self, g):
        self.answers[g] = [{"vel": out[0], "baz": out[1], "mdccm": out[2], "t": out[3],
                            "sig_tau": out[5], "num_compute": list(out[6])}
                           for out in self.last]

    def drop(self, g):
        self.answers.pop(g, None)

    def answer(self, g, deployment):
        ans = self.answers.get(g)
        if ans is None or self.fault in ("none", "coords0"):
            return ans
        return {"swap": ans[::-1], "short": ans[:1], "one_none": [ans[0], None]}[self.fault]

    def present(self, g, arrived):
        return g in arrived

    def route(self):
        return {"xcorr_method": "per array", "precision": "per array"}

    def free(self):
        self.api.set_performance_defaults()
        self.last = None

    def disk_bytes(self):
        return 0

    def close(self):
        self.free()
'''


def network_cfg(arrays=ARRAYS):
    cfg = json.loads((ROOT / "portbench/configs/i53_onethird.json").read_text())
    del cfg["array"]
    cfg.update(name="network_test", FMIN=2.5, SEGMENT_S=300.0, arrays=arrays)
    return cfg


def network_traffic(fault="none"):
    traffic = json.loads((ROOT / "portbench/traffic/archive.json").read_text())
    traffic.update(entry="network_test", pool_segments=2, warmup_calls=1, check_segments=2,
                   fault=fault)
    return traffic


def checkout(root, cfg):
    """A checkout at ``root`` with configuration ``cfg`` (its ``name``)
    and, for each fault, the traffic ``network_<fault>`` and the cell
    ``network.<fault>``."""
    shutil.copytree(ROOT / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    path = f"portbench/configs/{cfg['name']}.json"
    (root / path).write_text(json.dumps(cfg))
    (root / "portbench/entries/network_test.py").write_text(NETWORK_ENTRY)
    bench["configs"].append({"name": cfg["name"], "source": cfg["source"], "file": path,
                             "reduced": [], "why": "a test"})
    cells = [f"network.{fault}" for fault in FAULTS]
    for fault, cell in zip(FAULTS, cells):
        (root / f"portbench/traffic/network_{fault}.json").write_text(
            json.dumps(network_traffic(fault)))
        bench["workloads"].append({"name": cell, "config": cfg["name"],
                                   "traffic": f"network_{fault}", "chips": 1, "why": "a test"})
    for m in bench["end_to_end"]:
        if m["name"] == "segment_p95_ms":
            m["workloads"].extend(cells)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


@pytest.fixture(scope="module")
def network_checkout(tmp_path_factory):
    return checkout(tmp_path_factory.mktemp("network"), network_cfg())


def run_network(root, fault, monkeypatch):
    """One run of the cell ``network.<fault>``: the last line, and each
    answer the check took, by name, beside whether it was None."""
    added = []
    real = check.Tally.add

    def add(self, name, ans, ref):
        added.append((name, ans is None))
        return real(self, name, ans, ref)
    monkeypatch.setattr(check.Tally, "add", add)
    rc, last, text = run_cell(["--workload", f"network.{fault}", "--seed", str(SEED),
                               "--seconds", "0.5", "--trace", "0"], root=root)
    assert rc == 0, text
    return last, added


def checked_segments(added):
    """The segments whose arrays were compared, each array's name beside."""
    by_segment = {}
    for name, _ in added:
        m = re.fullmatch(r"segment (\d+) array (\w+)", name)
        assert m, name
        by_segment.setdefault(int(m[1]), []).append(m[2])
    return by_segment


def test_a_network_entry_is_correct(network_checkout, monkeypatch):
    """Every (segment, array) checked is one due answer under its array's
    name, against the reference on that array's own data and geometry."""
    last, added = run_network(network_checkout, "none", monkeypatch)
    assert last["correct"] is True, last["checks"]
    assert last["checks"]["missing"]["value"] == 0
    segments = checked_segments(added)
    assert segments and all(names == ["north", "south"] for names in segments.values())
    assert not any(none for _, none in added)


def test_swapped_arrays_are_not_correct(network_checkout, monkeypatch):
    last, _ = run_network(network_checkout, "swap", monkeypatch)
    assert last["correct"] is False
    assert last["checks"]["missing"]["value"] == 0
    assert last["checks"]["mdccm_err"]["value"] > last["checks"]["mdccm_err"]["limit"]


@pytest.mark.parametrize("fault, missing_an_array", [("short", 2), ("one_none", 1)])
def test_an_array_answer_dropped_is_missing(network_checkout, monkeypatch, fault,
                                            missing_an_array):
    """A list of one answer for two arrays counts both missing; None in an
    array's place counts that array's."""
    last, added = run_network(network_checkout, fault, monkeypatch)
    segments = checked_segments(added)
    assert last["correct"] is False
    assert last["checks"]["missing"]["value"] == missing_an_array * len(segments) >= 1


def test_every_array_answered_on_the_first_arrays_geometry_is_not_correct(
        network_checkout, monkeypatch):
    """The second array solved on the first's coordinates (twice its
    aperture): the same correlations, other slownesses."""
    last, _ = run_network(network_checkout, "coords0", monkeypatch)
    assert last["correct"] is False
    assert last["checks"]["missing"]["value"] == 0
    assert last["checks"]["window_share"]["value"] > last["checks"]["window_share"]["limit"]


def test_each_array_draws_its_own_wave():
    """Each (segment, array) has its own draws and seed: the two arrays'
    waves differ in one segment even where their rings are the same."""
    same_place = [dict(ARRAYS[0]), dict(ARRAYS[0], name="twin")]
    for arrays in (ARRAYS, same_place):
        tr = Traffic(network_cfg(arrays), network_traffic(), SEED)
        for v in tr.draws.values():
            assert v.shape == (2, 2) and v[0, 0] != v[0, 1]
        seg = tr.segment(0)
        assert seg.shape == (2, 8, tr.npts)
        assert not np.allclose(seg[0], seg[1])
    assert [name for name, _, _ in tr.arrays] == ["north", "twin"]
    assert tr.arrays[0][1:] == tr.arrays[1][1:]
    assert not hasattr(tr, "lats")


def test_a_networks_calls_and_contexts_carry_the_arrays_first():
    """A call's data is (A, C, span), a view or, past the pool's end, the
    segments joined on the time axis; a context is (A, C, T)."""
    params = dict(network_traffic(), context_segments=2)
    tr = Traffic(network_cfg(), params, SEED)
    T = tr.npts
    assert tr.ring.shape == (2, 8, 3 * T)
    for k in range(4):
        call = tr.call(k)
        ctx = min(2, k)
        assert call.data.shape == (2, 8, (ctx + 1) * T)
        want = np.concatenate([tr.segment(g) for g in range(k - ctx, k + 1)], axis=-1)
        assert np.array_equal(call.data, want)
    assert tr.context_of(0) is None and tr.context_of(1).shape == (2, 8, T)
    assert [x.shape for x in tr.per_array(tr.segment(1))] == [(8, T), (8, T)]
    assert tr.per_array(tr.context_of(0)) == [None, None]


MALFORMED = {
    "both": lambda c: c.update(array=ARRAYS[0]),
    "neither": lambda c: c.pop("arrays"),
    "one": lambda c: c.update(arrays=ARRAYS[:1]),
    "repeated": lambda c: c.update(arrays=[ARRAYS[0], dict(ARRAYS[1], name="north")]),
    "unnamed": lambda c: c.update(arrays=[ARRAYS[0], {k: v for k, v in ARRAYS[1].items()
                                                      if k != "name"}]),
    "no_ring": lambda c: c.update(arrays=[ARRAYS[0], {"name": "south", "lat0": 63.9}]),
    "unknown_key": lambda c: c.update(arrays=[ARRAYS[0], dict(ARRAYS[1], baz_deg=210.0)]),
    "not_an_object": lambda c: c.update(arrays=[ARRAYS[0], "south"]),
}


@pytest.mark.parametrize("fault", sorted(MALFORMED))
def test_a_malformed_network_is_refused_naming_its_file(tmp_path, fault):
    cfg = network_cfg()
    MALFORMED[fault](cfg)
    root = checkout(tmp_path, cfg)
    with pytest.raises(ValueError, match=re.escape("portbench/configs/network_test.json: ")):
        Spec(root).config("network_test")
    with pytest.raises(ValueError, match="the configuration: "):
        Traffic(cfg, network_traffic(), SEED)
    with pytest.raises(ValueError, match="network_test.json"):
        run_cell(["--workload", "network.none", "--seed", "1", "--seconds", "0.1"], root=root)


@pytest.mark.parametrize("key", ["name", "baz_deg"])
def test_one_array_with_a_key_besides_its_ring_is_refused(key):
    cfg = json.loads((ROOT / "portbench/configs/i53_example.json").read_text())
    cfg["array"][key] = "x"
    with pytest.raises(ValueError, match=f"i53_example.json: .*holds besides \\['{key}'\\]"):
        arrays_of(cfg, "portbench/configs/i53_example.json")


def test_one_array_is_a_list_of_one():
    cfg = json.loads((ROOT / "portbench/configs/i53_example.json").read_text())
    ((name, lats, lons),) = arrays_of(cfg)
    assert name == "i53_example"
    assert (lats, lons) == default_array_coords(8, 2.0, 64.8738, -147.8614)


# SHA-256 of `Traffic(config, traffic, seed).ring`, each accepted cell's
# pair at seeds 0 and 1, as the harness made them before it knew of networks
PINNED = {
    ("i53_example", "archive", 0):
        "8ee5b0dae0bd3e5706d23689c2f25bb8962d0958fef5a42150a53eb832275d61",
    ("i53_example", "archive", 1):
        "adacdfaf8e9f667b8e1eebc37a1f80bd45a50d522e18e4cfca75c8c68e1e9988",
    ("i53_onethird", "archive", 0):
        "8ee5b0dae0bd3e5706d23689c2f25bb8962d0958fef5a42150a53eb832275d61",
    ("i53_onethird", "archive", 1):
        "adacdfaf8e9f667b8e1eebc37a1f80bd45a50d522e18e4cfca75c8c68e1e9988",
    ("i53_example_lts", "archive_outlier", 0):
        "a43f1eb4e4176306252344174201556a0bfb09f4083edace88f282ef1ef5ddb3",
    ("i53_example_lts", "archive_outlier", 1):
        "8a07d7ec09a150ea56c40adabbeea7481112e3eb0e959aefc06b55e62c862d60",
    ("i53_onethird_fp32", "archive", 0):
        "8ee5b0dae0bd3e5706d23689c2f25bb8962d0958fef5a42150a53eb832275d61",
    ("i53_onethird_fp32", "archive", 1):
        "adacdfaf8e9f667b8e1eebc37a1f80bd45a50d522e18e4cfca75c8c68e1e9988",
}


@pytest.mark.parametrize("config, traffic, seed", sorted(PINNED), ids=lambda v: str(v))
def test_one_arrays_pool_is_byte_for_byte_as_pinned(config, traffic, seed):
    spec = Spec()
    tr = Traffic(spec.config(config), spec.traffic(traffic), seed)
    assert tr.ring.shape == (8, 33 * tr.npts) and tr.ring.dtype == np.float64
    assert hashlib.sha256(tr.ring.tobytes()).hexdigest() == PINNED[(config, traffic, seed)]
