"""PyTorch port: the counterpart of ``tests/test_perf_gate.py``, on the CPU.

XLA's ``memory_analysis`` and the optimized-HLO collective audit have no
PyTorch equivalent (the port runs eagerly), so the same two failure modes
are gated on what a run does:

- memory: the peak bytes of the tensors a step holds alive at once, by a
  ``TorchDispatchMode`` that counts every storage an operation returns
  until it is freed (`PeakBytes`), for one canonical ``run_raw`` (8
  elements, 20 Hz, 1200 s, 8 log bands) and a 20-band plan of the same
  data.  A correlation tensor that materialised unbounded, or a merge
  that grew superlinearly with bands, shows here first.  Measured on the
  CPU (kernels' plain versions): 67.7 MB canonical, 141.3 MB at 20 bands;
  the budgets are about twice that, and the 20-band to 8-band ratio (2.09
  for 2.5 times the bands) must stay below 3;
- collectives: one step of the sharded pipeline on a (2, 4) mesh of eight
  gloo processes (the worker `parallel.smoke`) moves exactly the halo
  (time shards but the last send ``C * halo`` float32 samples to their
  right neighbour, the halo reckoned from the filter bank) and the final
  all-gather of the packed outputs (6 x S/nt x B/nb x Wmax float32 a
  rank); nothing crosses the band axis before it: no broadcast, no host
  copy.
"""

import weakref

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from narrow_band_least_squares_tpu_torch.io import synthetic_plane_wave
from narrow_band_least_squares_tpu_torch.models import NarrowBandPipeline
from narrow_band_least_squares_tpu_torch.parallel import ShardedNarrowBandPipeline
from narrow_band_least_squares_tpu_torch.parallel.smoke import inputs, launch
from narrow_band_least_squares_tpu_torch.utils import (
    get_freqlist,
    get_rij,
    get_winlenlist,
    make_plan,
)

CANONICAL_BUDGET = 140e6      # bytes; measured 67.7 MB
DENSE20_BUDGET = 290e6        # bytes; measured 141.3 MB
MAX_RATIO_20_TO_8 = 3.0       # measured 2.09 for 2.5x the bands


class PeakBytes(TorchDispatchMode):
    """While entered, the peak of the bytes held by storages that
    operations returned and that are still alive (views of a storage
    count once; storages made before entering do not count)."""

    def __init__(self):
        super().__init__()
        self.live = self.peak = 0
        self._sizes = {}

    def _free(self, key):
        self.live -= self._sizes.pop(key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor):
                st = t.untyped_storage()
                key = id(st)
                if key not in self._sizes and st.nbytes():
                    self._sizes[key] = st.nbytes()
                    self.live += st.nbytes()
                    self.peak = max(self.peak, self.live)
                    weakref.finalize(st, self._free, key)
        return out


@pytest.fixture(scope="module")
def canonical():
    st = synthetic_plane_wave(nchans=8, duration_s=1200.0, fs=20.0, baz_deg=230.0,
                              trace_vel_kms=0.34, f0=0.8, bandwidth=1.2, snr=8.0, seed=42)
    return st, get_rij(st.latitudes, st.longitudes, st.nchans)


def _peak(st, rij, nbands, **kw):
    fl, nb, _ = get_freqlist(0.1, 5.0, "log", nbands)
    plan = make_plan(fl, "log", get_winlenlist("adaptive", nb, 50, 60, 30), 0.5,
                     st.npts, st.fs)
    pipe = NarrowBandPipeline(plan, rij, device="cpu", **kw)
    with PeakBytes() as m:
        out = pipe.run_raw(st.data)
    assert bool(torch.isfinite(out["mdccm"]).all())
    return m.peak


def test_peak_bytes_tracker_counts_storages_once():
    with PeakBytes() as m:
        a = torch.zeros(1000)              # 4000 bytes
        v = a[10:20]                       # a view: no new storage
        b = a + 1                          # 4000 more
        del a, b
        c = torch.ones(250)                # 1000: the peak stays 8000
    assert m.peak == 8000
    assert m.live == 5000                  # a's storage lives on in the view
    del v, c


def test_canonical_step_memory_budget(canonical):
    """Mirror of ``test_perf_gate.py:63``."""
    peak = _peak(*canonical, 8)
    assert peak < CANONICAL_BUDGET, f"{peak / 1e6:.1f} MB"


def test_dense_sweep_memory_budget(canonical):
    """Mirror of ``test_perf_gate.py:80``: 20 bands stay within budget and
    grow the peak about linearly with the bands, not superlinearly."""
    p8, p20 = _peak(*canonical, 8), _peak(*canonical, 20)
    assert p20 < DENSE20_BUDGET, f"{p20 / 1e6:.1f} MB"
    assert p20 / p8 < MAX_RATIO_20_TO_8, f"{p20 / p8:.2f}"


def test_subsample_step_memory_budget(canonical):
    """The neighbour route adds four (rows,) vectors, not a correlation."""
    base, sub = _peak(*canonical, 8), _peak(*canonical, 8, subsample_delays=True)
    assert sub < CANONICAL_BUDGET and sub < 1.1 * base, (base, sub)


def test_sharded_step_collectives(tmp_path):
    """Mirror of ``test_perf_gate.py:104`` on a (2, 4) gloo mesh of eight
    processes: per rank exactly the halo and the final all-gather."""
    nt, nb = 2, 4
    st, plan, rij, _ = inputs("small")
    ref = ShardedNarrowBandPipeline(plan, rij, None, mesh_shape=(nt, nb), device="cpu")
    S = len(ref.segment_stream(st.data))
    stats, _ = launch(nt * nb, ["--mesh-time", str(nt), "--mesh-band", str(nb),
                                "--device", "cpu", "--backend", "gloo",
                                "--out", str(tmp_path / "rank0.npz")],
                      timeout_s=300.0, threads=1)
    assert [s["rank"] for s in stats] == list(range(nt * nb))
    halo = st.nchans * ref.halo * 4
    packed = 6 * (S // nt) * ref.B_loc * plan.max_windows * 4
    for s in stats:
        assert s["mode"] == "bucket"
        assert s["halo_bytes"] == (halo if s["t"] < nt - 1 else 0), s
        assert s["gather_bytes"] == packed, s
        assert s["broadcast_bytes"] == 0 and s["host_copy_bytes"] == 0, s
        assert s["host_copy_kinds"] == [], s
