"""Multi-array batch processing: many infrasound arrays per device step.

Port of ``narrow_band_least_squares_tpu/models/multiarray.py`` for OLS on
one device.  The arrays share the band/window plan and element count; each
has its own geometry.  Each array is filtered on its own, the delay search
runs with the arrays merged into one batch (`NarrowBandPipeline.
_delays_batched`: the window axis for 'mxu', the band rows of one fused
launch per bucket for 'fused'), and each array is solved with its own
co-array.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

from narrow_band_least_squares_tpu_torch.models.narrowband import (
    NarrowBandPipeline,
    _not_ported,
)
from narrow_band_least_squares_tpu_torch.ops import solve as SOLVE
from narrow_band_least_squares_tpu_torch.utils.geometry import coarray
from narrow_band_least_squares_tpu_torch.utils.plan import NarrowBandPlan


class MultiArrayPipeline:
    """Process A arrays of identical element count in one step.

    Args:
        plan: shared band/window plan.
        rij_list: per-array (2, N) geometries (same N across arrays).
        mesh: must be None; sharding the arrays over devices is not ported
            yet (ROADMAP.md, Queue 1 item 9).
        merge_chunk_arrays: how many arrays share one delay batch; 0 or None
            merges all of them.  The JAX package chunks to stay under an XLA
            tiling cliff on the TPU; the port keeps the option so both run
            the same batches.
        device: keyword-only; ``None`` means ``"cuda"`` and raises without
            CUDA.
        base_kwargs: forwarded to the base `NarrowBandPipeline`
            (xcorr_method, window_method, max_lag_s, bucket_bands,
            matmul_precision, ...).  The merged delay search ('mxu',
            'pallas' or 'fused') runs at the base's ``matmul_precision``, on
            the same kernel route as a single array (3xTF32 tensor cores at
            the default 'high').
    """

    def __init__(
        self,
        plan: NarrowBandPlan,
        rij_list: Sequence[np.ndarray],
        filter_type: str = "cheby1",
        filter_order: int = 2,
        filter_ripple: float = 0.01,
        alpha: float = 1.0,
        dtype=torch.float32,
        c_steps: int = 4,
        mesh=None,
        merge_chunk_arrays: int = 2,
        *,
        device=None,
        **base_kwargs,
    ):
        nchans = {np.asarray(r).shape[1] for r in rij_list}
        if len(nchans) != 1:
            raise ValueError(
                f"all arrays must have the same element count, got {nchans}"
            )
        if float(alpha) < 1.0:
            raise _not_ported("alpha < 1 (LTS)", "Queue 1 item 6")
        if mesh is not None:
            raise _not_ported("MultiArrayPipeline(mesh=...)", "Queue 1 item 9")
        self.nchans = nchans.pop()
        self.A = len(rij_list)
        self.merge_chunk_arrays = int(merge_chunk_arrays or self.A)
        self.base = NarrowBandPipeline(
            plan, rij_list[0],
            filter_type=filter_type, filter_order=filter_order,
            filter_ripple=filter_ripple, alpha=alpha, dtype=dtype,
            c_steps=c_steps, device=device, **base_kwargs,
        )
        self.plan = plan
        self.device = self.base.device

        geo = [SOLVE.precompute_lstsq(coarray(np.asarray(r, dtype=np.float64))[0])
               for r in rij_list]
        self._geometry = tuple(
            torch.as_tensor(np.stack([g[k] for g in geo]), dtype=dtype,
                            device=self.device)
            for k in ("X", "pinv", "XtX_inv")
        )

    def run_raw(self, data: np.ndarray) -> Dict[str, torch.Tensor]:
        """data: (A, C, T) -> dict of (A, B, Wmax) device tensors."""
        base = self.base
        x = base._to_device(data)
        if x.shape[0] != self.A:
            raise ValueError(f"expected {self.A} arrays, got {x.shape[0]}")
        y = torch.stack([base._filter(x[a]) for a in range(self.A)])
        ca = self.merge_chunk_arrays
        outs = [base._delays_batched(y[i:i + ca]) for i in range(0, self.A, ca)]
        tau, _, mdccm = (torch.cat(v) for v in zip(*outs))
        res = [base._solve_masked(tau[a], mdccm[a],
                                  tuple(g[a] for g in self._geometry))
               for a in range(self.A)]
        return {k: torch.stack([r[k] for r in res]) for k in res[0]}
