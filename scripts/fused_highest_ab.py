"""Times the fused delay search at matmul_precision 'highest' on one GPU,
for the port's package in any checkout, so that two trees are compared in
one call on one card (parent, change, change, parent):

    python3 scripts/fused_highest_ab.py --root path/to/other/checkout --label parent
    python3 scripts/fused_highest_ab.py --label change      # this checkout

Per plan (the canonical plan and the 50-band plan of ``chip_smoke.py``):
``fused_xcorr_bucket``'s device ms per step (each bucket's launch queued
back to back behind a spin kernel, ``chip_smoke.device_ms``) beside its
bound, a ``torch.profiler`` profile of 5 steps (device ms per kernel, so
per pass), and the step by CUDA events; then the four-array step
(``MultiArrayPipeline``) by events.  ``--variants`` instead times the
route with each K-part count of the inverse DFT
(``chip_smoke.FUSED_HIGHEST_VARIANTS``) per step, in turns bucket by
bucket.  The timing helpers are this
checkout's ``chip_smoke.py``; the package timed is the one under
``--root``.  Exits non-zero without a GPU.
"""

from __future__ import annotations

import argparse
import importlib.util
import os
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(HERE),
                    help="checkout whose narrow_band_least_squares_tpu_torch is timed")
    ap.add_argument("--label", default="this checkout")
    ap.add_argument("--variants", action="store_true",
                    help="time the inverse's K-part counts instead (this checkout's package)")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    import torch

    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is false: the timing needs a GPU")
    torch.set_float32_matmul_precision("highest")
    from narrow_band_least_squares_tpu_torch.models import MultiArrayPipeline
    from narrow_band_least_squares_tpu_torch.ops.kernels import fused_xcorr as FX
    from narrow_band_least_squares_tpu_torch.utils import get_rij, make_plan

    if not FX.__file__.startswith(root):
        cs.fail(f"imported {FX.__file__}, not the package under {root}")
    tag = f"[{cs.gpu_label()}] [{args.label}]"
    st, freqlist, winlens = cs.canonical_inputs()
    rij = get_rij(st.latitudes, st.longitudes, st.nchans)
    plans = {"canonical": make_plan(freqlist, "log", winlens, cs.WINOVER, st.npts, st.fs),
             "dense50": cs.dense50_plan(st)}
    if args.variants:
        for name, plan in plans.items():
            pipe = cs.fused_pipeline(plan, rij, matmul_precision="highest")
            tot = dict.fromkeys(cs.FUSED_HIGHEST_VARIANTS, 0.0)
            for a in cs.capture_fused_inputs(pipe, st.data):
                for v, ms in cs.fused_highest_variants(a).items():
                    tot[v] += ms
            cs.log(f"{tag} fused_xcorr_bucket@highest per {name} step by the "
                   f"inverse's K parts, device ms: "
                   + ", ".join(f"{k}: {ms:.4f}" for k, ms in tot.items()))
        return 0
    for name, plan in plans.items():
        pipe = cs.fused_pipeline(plan, rij, matmul_precision="highest")
        kernel = fwd = inv = nbytes = 0.0
        seen = cs.capture_fused_inputs(pipe, st.data)
        for i, a in enumerate(seen):
            ff, fi, b = cs.fused_work(plan, pipe._buckets[i]["grid"].band_idx, a)
            ms = cs.device_ms(lambda: FX.fused_xcorr_bucket(*a, precision="highest"),
                              reps=10)
            cs.log(f"{tag} {name} bucket {i}: y {tuple(a[0].shape)} Lg={a[5].shape[1]} "
                   f"Kp={a[6].shape[1]} nlag={a[8].shape[1]} W={a[11]}: kernel "
                   f"{ms:.4f} ms")
            kernel += ms
            fwd, inv, nbytes = fwd + ff, inv + fi, nbytes + b
        bound, by = cs.fused_bound_ms(fwd, inv, nbytes, "highest")
        cs.log(f"{tag} fused_xcorr_bucket@highest per {name} step: {kernel:.4f} ms, "
               f"bound {bound:.4f} ms by {by} ({100 * bound / kernel:.1f}% of bound)")
        step = cs.cuda_time_ms(lambda: pipe.run_raw(st.data), reps=20)
        cs.log(f"{tag} {name} 'fused' step at highest by events: {step:.4f} ms")
        cs.profile_step(f"{tag} fused highest", pipe, st.data, name=name)
        # the clock the card holds under this load: the largest bucket back
        # to back for about 3 s
        a = max(seen, key=lambda a: a[0].shape[0] * a[11])
        n = max(1, int(3000 / cs.device_ms(lambda: FX.fused_xcorr_bucket(
            *a, precision="highest"), reps=3)))
        with cs.SmClock() as clock:
            for _ in range(n):
                FX.fused_xcorr_bucket(*a, precision="highest")
            torch.cuda.synchronize()
        cs.log(f"{tag} {name}: {n} launches of its largest bucket back to back: "
               f"{clock.summary()}")
    mplan, rijs, data = cs.multiarray_inputs()
    multi = MultiArrayPipeline(mplan, rijs, xcorr_method="fused",
                               matmul_precision="highest", device="cuda")
    ms = cs.cuda_time_ms(lambda: multi.run_raw(data), reps=10)
    cs.log(f"{tag} multiarray A={len(rijs)} 'fused' step at highest by events: {ms:.4f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
