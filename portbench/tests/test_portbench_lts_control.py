"""The control of the LTS cell ``i53.lts_archive``: the port with its own
lower-precision path switched on (``matmul_precision='default'``: the lag
search in one tf32 pass, against the configuration's float32) has to come
out not correct.

On the CPU the port computes in float32 whatever the precision says, so
the CPU test runs the lag search's plain version at 'default' (the
tensor-core route's rounding emulated bit for bit), on the cell's
configuration and traffic cut to 2 bands of 300 s segments in a temporary
checkout.  On the card (``card``) the cell runs at its own size on three
seeds.  For the readings the limits are set from, on the chip:

    python3 portbench/tests/test_portbench_lts_control.py <seconds> <seed>...
"""

import json
import shutil
import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent))

from conftest import ROOT, run_cell  # noqa: E402

CELL = "i53.lts_archive"
SEEDS = [2 ** 31 + 21, 2 ** 31 + 22, 2 ** 31 + 23]


def control(cell, seed, seconds, device, root=ROOT):
    rc, last, text = run_cell(["--workload", cell, "--seed", str(seed), "--seconds",
                               str(seconds), "--trace", "0"], device=device,
                              options={"matmul_precision": "default"}, root=root)
    assert rc == 0, text
    return last


def small_checkout(root):
    """A checkout at ``root`` whose cell ``i53.lts_archive`` runs its
    configuration in 2 bands of 300 s segments, over a pool of 2."""
    shutil.copytree(ROOT / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    cfg_path = root / "portbench/configs/i53_example_lts.json"
    cfg = json.loads(cfg_path.read_text())
    cfg.update(NBANDS=2, SEGMENT_S=300.0)
    cfg_path.write_text(json.dumps(cfg))
    traffic_path = root / "portbench/traffic/archive_outlier.json"
    traffic = json.loads(traffic_path.read_text())
    traffic.update(pool_segments=2, warmup_calls=1, check_segments=1)
    traffic_path.write_text(json.dumps(traffic))
    return root


def test_the_small_cell_is_correct_on_the_cpu(tmp_path):
    """The same cut of the cell, as the port computes it, is correct."""
    rc, last, text = run_cell(["--workload", CELL, "--seed", str(SEEDS[0]), "--seconds",
                               "0.5", "--trace", "0"], root=small_checkout(tmp_path))
    assert rc == 0, text
    assert last["correct"] is True, last["checks"]


def test_control_is_not_correct_on_the_cpu(tmp_path, monkeypatch):
    from narrow_band_least_squares_tpu_torch.ops.kernels import xcorr_peak as XP

    real = XP.icorr_peak_reference
    monkeypatch.setattr(XP, "icorr_peak_reference",
                        lambda *a, **kw: real(*a, **dict(kw, precision="default")))
    last = control(CELL, SEEDS[0], 0.5, "cpu", root=small_checkout(tmp_path))
    assert last["correct"] is False
    assert last["checks"]["mdccm_err"]["value"] > last["checks"]["mdccm_err"]["limit"]


@pytest.mark.card
def test_control_is_not_correct_on_the_card(card):
    for seed in SEEDS:
        last = control(CELL, seed, 5, None)
        assert last["correct"] is False, (seed, last["checks"])


if __name__ == "__main__":
    seconds, seeds = float(sys.argv[1]), sys.argv[2:]
    for s in seeds:
        last = control(CELL, int(s), seconds, None)
        print(json.dumps({"cell": CELL, "seed": int(s), "control": "default",
                          "correct": last["correct"], "checks": last["checks"]}), flush=True)
