"""Sharded example: a long stream over a (time, band) mesh of processes.

The port's counterpart of ``examples/example_parallel.py``: a 2 h stream in
1200 s segments, 8 log bands over 0.1-5 Hz, the mesh shape from
`parallel.auto_mesh_shape` over the world size, one process per rank on
``torch.distributed``.  In one process it runs the 1x1 mesh with no process
group.  Run:

    python -m narrow_band_least_squares_tpu_torch.examples.example_parallel [--cpu]
    torchrun --nproc-per-node=N -m narrow_band_least_squares_tpu_torch.examples.example_parallel

Under ``torchrun`` the backend is NCCL on GPUs (one rank per GPU) and gloo
with ``--cpu``; ``--gloo`` names gloo for several ranks on one GPU (the
halos and the assembly then go through explicit host copies).  Rank 0
prints the result; every rank returns it.
"""

import argparse

import numpy as np

from narrow_band_least_squares_tpu_torch.io import synthetic_plane_wave
from narrow_band_least_squares_tpu_torch.parallel import (
    ShardedNarrowBandPipeline,
    auto_mesh_shape,
    initialize_distributed,
    make_mesh,
)
from narrow_band_least_squares_tpu_torch.utils.geometry import get_rij
from narrow_band_least_squares_tpu_torch.utils.plan import (
    get_freqlist,
    get_winlenlist,
    make_plan,
)

NCHANS, FS = 8, 20.0
FMIN, FMAX, NBANDS = 0.1, 5.0, 8
WINLEN, WINLEN_1, WINLEN_X = 50, 60, 30
SEGMENT_S = 1200.0      # one reference-sized run per segment
HOURS = 2.0             # total stream duration to process
MDCCM_THRESH = 0.6


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true",
                    help="run the kernels' plain PyTorch versions on the CPU")
    ap.add_argument("--gloo", action="store_true",
                    help="gloo on the card: several ranks on one GPU")
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else "cuda"

    import torch.distributed as dist

    initialize_distributed("gloo" if args.gloo else None, device=device)
    n = dist.get_world_size() if dist.is_initialized() else 1
    nt, nb = auto_mesh_shape(n, nbands=NBANDS)
    mesh = make_mesh(nt, nb)
    if mesh.rank == 0:
        print(f"processes={n} mesh=(time={nt}, band={nb})")

    # the stream must cover at least one segment per time shard
    duration_s = max(HOURS * 3600.0, nt * SEGMENT_S)
    st = synthetic_plane_wave(
        nchans=NCHANS, duration_s=duration_s, fs=FS, baz_deg=230.0,
        trace_vel_kms=0.34, f0=0.8, bandwidth=1.4, snr=6.0, seed=42,
    )
    freqlist, nbands, fmax = get_freqlist(FMIN, FMAX, "log", NBANDS)
    winlens = get_winlenlist("adaptive", nbands, WINLEN, WINLEN_1, WINLEN_X)
    plan = make_plan(freqlist, "log", winlens, 0.5, int(SEGMENT_S * st.fs), st.fs)
    rij = get_rij(st.latitudes, st.longitudes, st.nchans)

    pipe = ShardedNarrowBandPipeline(plan, rij, mesh, filter_type="cheby1", alpha=1.0,
                                     device=device)
    segs = pipe.segment_stream(st.data)
    out = pipe.run(segs)

    good = out["mdccm"] > MDCCM_THRESH
    if mesh.rank == 0:
        print(f"segments={segs.shape[0]} bands={plan.nbands} "
              f"windows/segment={plan.max_windows}")
        print(f"good windows: {int(good.sum())}/{good.size}  "
              f"median baz={np.median(out['baz'][good]):.1f} deg  "
              f"median vel={np.median(out['vel'][good]):.3f} km/s")
    if dist.is_initialized():
        dist.destroy_process_group()
    return out, good


if __name__ == "__main__":
    main()
