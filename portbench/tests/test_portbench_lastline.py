"""A run's last line: exactly ``correct``, ``attempted``, ``failed``,
``metrics``, ``device`` (with ``--trace 1`` also ``breakdown``), and the
numbers compared under ``checks``, last; the cell's metrics by trace
mode.  On the CPU (the harness's look for a chip skipped)."""

import pytest

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("trace", [0, 1])
def test_last_line_keys(run, trace):
    rc, last, _ = run(["--workload", "i53.archive", "--seed", str(2 ** 31 + 7),
                       "--seconds", "1", "--trace", str(trace)])
    assert rc == 0
    assert list(last) == KEYS + (["breakdown"] if trace else []) + ["checks"]
    assert last["correct"] is True and last["failed"] == 0 and last["attempted"] >= 1
    assert set(last["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    if trace:
        assert {"busy_s", "window_s"} <= set(last["device"])
        # the device's readers find nothing to read on the CPU
        assert set(last["metrics"]) == {"call_windows_per_s"}
        assert set(last["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert set(last["metrics"]) == {"segment_p95_ms", "setup_s"}
        assert all(set(v) == {"value", "unit"} for v in last["metrics"].values())
    assert list(last["checks"]) == ["missing", "mdccm_err", "window_share"]


def test_without_a_card_no_result(run):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    rc, last, text = run(["--workload", "i53.archive", "--seed", "1", "--seconds", "1"],
                         device=None)
    assert rc == 2 and last is None and text == ""


def test_same_seed_same_inputs():
    from portbench.harness.spec import Spec
    from portbench.harness.traffic import Traffic

    spec = Spec()
    cfg, params = spec.config("i53_example"), dict(spec.traffic("archive"), pool_segments=2)
    a, b = Traffic(cfg, params, 2 ** 33 + 1), Traffic(cfg, params, 2 ** 33 + 1)
    c = Traffic(cfg, params, 2 ** 33 + 2)
    assert (a.ring == b.ring).all() and not (a.ring == c.ring).all()
