"""A run with the timed path broken underneath sees ``correct`` come out
false, once for each fault the cells can have: an answer altered where it
is produced (the solve's back-azimuth, or MdCCM), and, in the monitor's
entry point, half of a batch's segments never persisted.  On the CPU, the
harness's look for a chip skipped.

An LTS cell (``ALPHA`` 0.75, element 3 incoherent; no cell of the
benchmark today, built in a temporary checkout) comes out correct as it
is, and not correct with one flag of every window of a band flipped, with
the port answering by OLS, or with the ``stdict`` dropped."""

import json

import pytest
import torch

CELLS = ["i53.archive", "onethird.archive"]


def argv(cell, seed=2 ** 31 + 99):
    return ["--workload", cell, "--seed", str(seed), "--seconds", "0.5", "--trace", "0"]


@pytest.fixture
def alter(monkeypatch):
    from narrow_band_least_squares_tpu_torch.models.narrowband import NarrowBandPipeline

    real = NarrowBandPipeline._solve_masked

    def install(key, delta):
        def solve(self, *a, **kw):
            out = dict(real(self, *a, **kw))
            bump = torch.zeros_like(out[key])
            bump[0] = delta                  # every window of the first band
            out[key] = out[key] + bump
            return out
        monkeypatch.setattr(NarrowBandPipeline, "_solve_masked", solve)
    return install


@pytest.mark.parametrize("cell", CELLS)
def test_altered_back_azimuth_is_not_correct(run, alter, cell):
    alter("baz", 0.01)
    rc, last, _ = run(argv(cell))
    assert rc == 0 and last["correct"] is False
    assert last["checks"]["window_share"]["value"] > last["checks"]["window_share"]["limit"]


def test_altered_mdccm_is_not_correct(run, monkeypatch):
    from narrow_band_least_squares_tpu_torch.models.narrowband import NarrowBandPipeline

    real = NarrowBandPipeline._delays

    def delays(self, y):
        tau, rho, mdccm = real(self, y)
        return tau, rho, mdccm * (1.0 + 1e-4)
    monkeypatch.setattr(NarrowBandPipeline, "_delays", delays)
    rc, last, _ = run(argv("i53.archive"))
    assert rc == 0 and last["correct"] is False
    assert last["checks"]["mdccm_err"]["value"] > last["checks"]["mdccm_err"]["limit"]


def test_half_a_batch_never_persisted_is_not_correct(tmp_path, monkeypatch):
    """The monitor's entry point (no cell of the benchmark today; the
    backlog cell of its traffic files, added back in a temporary checkout)."""
    import shutil

    from conftest import ROOT, run_cell
    from narrow_band_least_squares_tpu_torch.models.streaming import StreamingMonitor

    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "i53.monitor_backlog", "config": "i53_example",
                               "traffic": "monitor_backlog", "chips": 1, "why": "a test"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    real = StreamingMonitor._persist_batch

    def persist(self, out, t0s, n):
        return real(self, out, t0s, n // 2)
    monkeypatch.setattr(StreamingMonitor, "_persist_batch", persist)
    rc, last, _ = run_cell(argv("i53.monitor_backlog"), root=tmp_path)
    assert rc == 0 and last["correct"] is False
    assert last["checks"]["missing"]["value"] > 0


def lts_checkout(root):
    """A checkout at ``root`` with the cell ``lts.small``: `i53_example` at
    ALPHA 0.75 in 2 bands of 300 s segments, the archive traffic with
    element 3 incoherent."""
    import shutil

    from conftest import ROOT

    shutil.copytree(ROOT / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads((ROOT / "portbench/configs/i53_example.json").read_text())
    cfg.update(name="lts_small", ALPHA=0.75, NBANDS=2, SEGMENT_S=300.0)
    (root / "portbench/configs/lts_small.json").write_text(json.dumps(cfg))
    traffic = json.loads((ROOT / "portbench/traffic/archive.json").read_text())
    traffic.update(pool_segments=2, warmup_calls=1, check_segments=1)
    traffic["source"]["outlier_channels"] = [2]
    (root / "portbench/traffic/lts_archive.json").write_text(json.dumps(traffic))
    bench["configs"].append({"name": "lts_small", "source": cfg["source"],
                             "file": "portbench/configs/lts_small.json", "reduced": [],
                             "why": "a test"})
    bench["workloads"].append({"name": "lts.small", "config": "lts_small",
                               "traffic": "lts_archive", "chips": 1, "why": "a test"})
    for m in bench["end_to_end"]:
        if m["name"] == "segment_p95_ms":
            m["workloads"].append("lts.small")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


@pytest.mark.parametrize("fault", ["none", "flag", "ols", "no_stdict"])
def test_lts_cell_flags_checked(tmp_path, monkeypatch, fault):
    from conftest import run_cell
    from narrow_band_least_squares_tpu_torch import api
    from narrow_band_least_squares_tpu_torch.models.narrowband import NarrowBandPipeline

    if fault == "flag":
        real_solve = NarrowBandPipeline._solve_masked

        def solve(self, *a, **kw):
            out = dict(real_solve(self, *a, **kw))
            flip = torch.zeros_like(out["flags"])
            flip[0, :, 0] = True             # the first pair, every window of band 0
            out["flags"] = out["flags"] ^ flip
            return out
        monkeypatch.setattr(NarrowBandPipeline, "_solve_masked", solve)
    elif fault in ("ols", "no_stdict"):
        real_api = api.narrow_band_least_squares

        def nbls(*a, **kw):
            if fault == "ols":
                return real_api(*a[:2], 1.0, *a[3:], **kw)
            out = real_api(*a, **kw)
            return out[:4] + (None,) + out[5:]
        monkeypatch.setattr(api, "narrow_band_least_squares", nbls)
    rc, last, text = run_cell(argv("lts.small", seed=7), root=lts_checkout(tmp_path))
    assert rc == 0, text
    checks = {k: v["value"] for k, v in last["checks"].items()}
    if fault == "none":
        assert last["correct"] is True, checks
    else:
        assert last["correct"] is False, checks
        if fault == "flag":
            assert checks["missing"] == 0
            assert checks["window_share"] > last["checks"]["window_share"]["limit"]
        else:
            assert checks["missing"] > 0
