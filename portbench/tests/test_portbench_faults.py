"""A run with the timed path broken underneath sees ``correct`` come out
false, once for each fault the cells can have: an answer altered where it
is produced (the solve's back-azimuth, or MdCCM), and, in the monitor's
entry point, half of a batch's segments never persisted.  On the CPU, the
harness's look for a chip skipped."""

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
