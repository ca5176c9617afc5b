"""The lag search's operations and bound from the plan's shapes: each
band's own windows and length, unpadded (PERF.md §3: 0.4546 ms a canonical
segment at 'high', 0.9156 ms in third-octave bands), and never more than
the port's own launches of ``icorr_peak`` do on the CPU."""

import numpy as np
import pytest

from portbench.harness.spec import Spec
from portbench.reference.batched import Deployment

BOUNDS_MS = {  # PERF.md §3, lag_search_roofline
    ("i53_example", "high"): 0.4546, ("i53_example", "default"): 0.1515,
    ("i53_example", "highest"): 1.1196,
    ("i53_onethird", "high"): 0.9156, ("i53_onethird", "default"): 0.3052,
    ("i53_onethird", "highest"): 2.2548,
}


def shapes(name):
    cfg = Spec().config(name)
    dep = Deployment(cfg, int(round(cfg["SEGMENT_S"] * cfg["FS"])))
    return ([wp.winlensamp for wp in dep.windows], [wp.n_windows for wp in dep.windows],
            cfg["NCHANS"] * (cfg["NCHANS"] - 1) // 2)


@pytest.mark.parametrize("key", sorted(BOUNDS_MS), ids=lambda k: f"{k[0]}-{k[1]}")
def test_bound_reproduces_perf_md(key):
    counts = Spec().module("counts", "lag_search")
    ms = counts.bound_seconds(*shapes(key[0]), key[1]) * 1e3
    assert ms == pytest.approx(BOUNDS_MS[key], abs=6e-5)


@pytest.mark.parametrize("name", ["i53_example", "i53_onethird"])
def test_operations_are_each_bands_own(name):
    """2 * 2 (L + 1) * (2 L - 1) a window and pair, summed band by band."""
    counts = Spec().module("counts", "lag_search")
    lens, wins, pairs = shapes(name)
    want = sum(2.0 * 2 * (L + 1) * (2 * L - 1) * W * pairs for L, W in zip(lens, wins))
    assert counts.work(lens, wins, pairs)["flops"] == want


def test_operations_at_most_the_ports_launches():
    """Every ``icorr_peak`` launch of one canonical step on the CPU: rows
    times spectral columns times each row's searched lags, summed, is at
    least the count (the port pads), and within a fifth of it."""
    import torch

    from narrow_band_least_squares_tpu_torch.models import NarrowBandPipeline
    from narrow_band_least_squares_tpu_torch.ops import xcorr as XC
    from narrow_band_least_squares_tpu_torch.utils.geometry import get_rij
    from narrow_band_least_squares_tpu_torch.utils.plan import make_plan

    from portbench.reference.synthetic import default_array_coords

    cfg = Spec().config("i53_example")
    dep = Deployment(cfg, 24000)
    plan = make_plan(dep.freqlist, "log", dep.winlens, 0.5, 24000, 20.0)
    lats, lons = default_array_coords(8)
    pipe = NarrowBandPipeline(plan, get_rij(lats, lons, 8), device="cpu")
    real, flops = XC.icorr_peak, []

    def rec(cs2, e2, lo, hi, **kw):
        span = torch.clamp(hi.long() - lo.long() + 1, min=0).sum().item()
        flops.append(2.0 * cs2.shape[1] * span)
        return real(cs2, e2, lo, hi, **kw)

    XC.icorr_peak = rec
    try:
        pipe.run_raw(np.random.default_rng(0).standard_normal((8, 24000)))
    finally:
        XC.icorr_peak = real
    counts = Spec().module("counts", "lag_search")
    plain = counts.work(*shapes("i53_example"))["flops"]
    assert plain <= sum(flops) <= 1.2 * plain
