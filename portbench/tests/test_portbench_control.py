"""The control: the port with its own lower-precision path switched on
(``matmul_precision='default'``: the lag search in one tf32 pass, against
the configuration's float32) has to come out not correct.

On the CPU the port computes in float32 whatever the precision says, so
the CPU test runs the lag search's plain version at 'default' (the
tensor-core route's rounding emulated bit for bit) at a small size.  On
the card (``card``) every cell runs at its own size on three seeds.  For
the readings the limits are set from, on the chip:

    python3 portbench/tests/test_portbench_control.py <cell> <seconds> <seed>...
"""

import json
import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent))

from conftest import run_cell  # noqa: E402

CELLS = ["i53.archive", "onethird.archive"]
SEEDS = [2 ** 31 + 11, 2 ** 31 + 12, 2 ** 31 + 13]


def control(cell, seed, seconds, device):
    rc, last, _ = run_cell(["--workload", cell, "--seed", str(seed), "--seconds",
                            str(seconds), "--trace", "0"], device=device,
                           options={"matmul_precision": "default"})
    assert rc == 0
    return last


def test_control_is_not_correct_on_the_cpu(monkeypatch):
    from narrow_band_least_squares_tpu_torch.ops.kernels import xcorr_peak as XP

    real = XP.icorr_peak_reference
    monkeypatch.setattr(XP, "icorr_peak_reference",
                        lambda *a, **kw: real(*a, **dict(kw, precision="default")))
    last = control("i53.archive", SEEDS[0], 0.5, "cpu")
    assert last["correct"] is False


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct_on_the_card(card, cell):
    for seed in SEEDS:
        last = control(cell, seed, 5, None)
        assert last["correct"] is False, (seed, last["checks"])


if __name__ == "__main__":
    cell, seconds, seeds = sys.argv[1], float(sys.argv[2]), sys.argv[3:]
    for s in seeds:
        last = control(cell, int(s), seconds, None)
        print(json.dumps({"cell": cell, "seed": int(s), "control": "default",
                          "correct": last["correct"], "checks": last["checks"]}), flush=True)
