"""The control of the cell ``onethird.fp32_archive``: the port with its own
lower-precision path switched on (``matmul_precision='default'``: both of
the fused kernel's products in one tf32 pass, against the configuration's
IEEE fp32) has to come out not correct.

On the CPU the port's fused route runs ``fused_xcorr_bucket_reference`` in
IEEE fp32 whatever the precision says, so the sound case runs the route as
it is and the control runs that plain version at 'default' (the
tensor-core route's rounding emulated bit for bit), on the cell's
configuration and traffic cut to 3 bands (``FMIN`` 2.5 Hz) of 300 s
segments, two of them checked, in a temporary checkout, where a lag altered where the fused
kernel produces it comes out not correct too.  On the card (``card``) the
control runs at the cell's own size on three seeds.  For the readings the limits
are set from, on the chip, at a precision (``highest``: the configuration
as it is; ``high``; ``default``: the control), in one process:

    python3 portbench/tests/test_portbench_fp32_control.py <precision> <seconds> <seed>...
"""

import json
import shutil
import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent))

from conftest import ROOT, run_cell  # noqa: E402

CELL, CONFIG = "onethird.fp32_archive", "i53_onethird_fp32"
SEEDS = [2 ** 31 + 31, 2 ** 31 + 32, 2 ** 31 + 33]


def run_at(precision, seed, seconds, device, root=ROOT):
    """One run of the cell, the configuration's ``matmul_precision`` set
    to ``precision``; the result's last line."""
    rc, last, text = run_cell(["--workload", CELL, "--seed", str(seed), "--seconds",
                               str(seconds), "--trace", "0"], device=device,
                              options={"matmul_precision": precision}, root=root)
    assert rc == 0, text
    return last


def small_checkout(root):
    """A checkout at ``root`` whose cell ``onethird.fp32_archive`` runs its
    configuration in 3 bands of 300 s segments, over a pool of 2, both
    checked."""
    shutil.copytree(ROOT / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    cfg_path = root / f"portbench/configs/{CONFIG}.json"
    cfg = json.loads(cfg_path.read_text())
    cfg.update(FMIN=2.5, SEGMENT_S=300.0)
    cfg_path.write_text(json.dumps(cfg))
    traffic_path = root / "portbench/traffic/archive.json"
    traffic = json.loads(traffic_path.read_text())
    traffic.update(pool_segments=2, warmup_calls=1, check_segments=2)
    traffic_path.write_text(json.dumps(traffic))
    return root


def test_the_small_cell_is_correct_on_the_cpu(tmp_path, capsys):
    """The same cut of the cell, as the port computes it on its fused route
    in IEEE fp32, is correct."""
    rc, last, text = run_cell(["--workload", CELL, "--seed", str(SEEDS[0]), "--seconds",
                               "0.5", "--trace", "0"], root=small_checkout(tmp_path))
    assert rc == 0, text
    assert "route: xcorr_method=fused matmul_precision=highest" in capsys.readouterr().err
    assert last["correct"] is True, last["checks"]


def test_control_is_not_correct_on_the_cpu(tmp_path, monkeypatch):
    from narrow_band_least_squares_tpu_torch.ops.kernels import fused_xcorr as FX

    real = FX.fused_xcorr_bucket_reference
    monkeypatch.setattr(FX, "fused_xcorr_bucket_reference",
                        lambda *a, **kw: real(*a, **dict(kw, precision="default")))
    last = run_at("default", SEEDS[0], 0.5, "cpu", root=small_checkout(tmp_path))
    assert last["correct"] is False
    assert last["checks"]["mdccm_err"]["value"] > last["checks"]["mdccm_err"]["limit"]


def test_a_lag_altered_where_the_fused_kernel_produces_it_is_not_correct(tmp_path,
                                                                       monkeypatch):
    """The fault the cell can have where its answers are produced: every
    lag of the first band row of each bucket one column off."""
    from narrow_band_least_squares_tpu_torch.ops.kernels import fused_xcorr as FX

    real = FX.fused_xcorr_bucket

    def bucket(*a, **kw):
        rho, idx = real(*a, **kw)
        idx = idx.clone()
        idx[0] += 1
        return rho, idx
    monkeypatch.setattr(FX, "fused_xcorr_bucket", bucket)
    rc, last, text = run_cell(["--workload", CELL, "--seed", str(SEEDS[1]), "--seconds",
                               "0.5", "--trace", "0"], root=small_checkout(tmp_path))
    assert rc == 0, text
    assert last["correct"] is False
    assert last["checks"]["window_share"]["value"] > last["checks"]["window_share"]["limit"]


@pytest.mark.card
def test_control_is_not_correct_on_the_card(card):
    for seed in SEEDS:
        last = run_at("default", seed, 5, None)
        assert last["correct"] is False, (seed, last["checks"])


if __name__ == "__main__":
    precision, seconds, seeds = sys.argv[1], float(sys.argv[2]), sys.argv[3:]
    for s in seeds:
        last = run_at(precision, int(s), seconds, None)
        print(json.dumps({"cell": CELL, "seed": int(s), "precision": precision,
                          "correct": last["correct"], "attempted": last["attempted"],
                          "checks": last["checks"]}), flush=True)
