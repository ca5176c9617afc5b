"""Multi-array batch processing: many infrasound arrays per device step.

Port of ``narrow_band_least_squares_tpu/models/multiarray.py``.  The
arrays share the band/window plan and element count; each has its own
geometry.  Each array is filtered on its own, the delay search
runs with the arrays merged into one batch (`NarrowBandPipeline.
_delays_batched`: the window axis for 'mxu', the band rows of one fused
launch per bucket for 'fused'), and each array is solved with its own
co-array (OLS, or LTS with its own candidates and the base pipeline's
``h``, ``c_steps``, ``lts_candidate_chunk`` and ``lts_funnel_k``).

On a mesh (``mesh=``) the arrays are data-parallel over its time axis, as
in the JAX package: time shard t takes arrays ``[t A/nt, (t+1) A/nt)``,
merges all of them into one delay batch, and the results are all-gathered
over the time group, so every rank returns all A arrays.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

from narrow_band_least_squares_tpu_torch.models.narrowband import NarrowBandPipeline
from narrow_band_least_squares_tpu_torch.parallel.mesh import Mesh
from narrow_band_least_squares_tpu_torch.state import state_from_numpy
from narrow_band_least_squares_tpu_torch.utils.geometry import coarray
from narrow_band_least_squares_tpu_torch.utils.plan import NarrowBandPlan


class MultiArrayPipeline:
    """Process A arrays of identical element count in one step.

    Args:
        plan: shared band/window plan.
        rij_list: per-array (2, N) geometries (same N across arrays).
        mesh: None (one device), or a `parallel.mesh.Mesh` whose time axis
            shards the arrays (``A % nt == 0``; band shards of one time
            shard compute the same arrays).
        merge_chunk_arrays: how many arrays share one delay batch; 0 or None
            merges all of them.  The JAX package chunks to stay under an XLA
            tiling cliff on the TPU; the port keeps the option so both run
            the same batches.  On a mesh a rank merges all of its arrays,
            as the JAX package does there.
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
        if mesh is not None and not isinstance(mesh, Mesh):
            raise TypeError(
                f"mesh must be a parallel.mesh.Mesh (make_mesh), got {type(mesh).__name__}")
        self.nchans = nchans.pop()
        self.A = len(rij_list)
        self.mesh = mesh
        if mesh is not None and self.A % mesh.nt:
            raise ValueError(f"{self.A} arrays are not a multiple of the mesh's "
                             f"{mesh.nt} time shards")
        # this rank's arrays
        A_loc = self.A if mesh is None else self.A // mesh.nt
        t = 0 if mesh is None else mesh.t
        self._arrays = range(t * A_loc, (t + 1) * A_loc)
        self.merge_chunk_arrays = (int(merge_chunk_arrays or self.A) if mesh is None
                                   else A_loc)
        self.base = NarrowBandPipeline(
            plan, rij_list[0],
            filter_type=filter_type, filter_order=filter_order,
            filter_ripple=filter_ripple, alpha=alpha, dtype=dtype,
            c_steps=c_steps, device=device, **base_kwargs,
        )
        self.plan = plan
        self.device = self.base.device

        # per array of this rank, its solve constants under the base
        # pipeline's policy: its co-array and, with LTS, its own candidates
        self._geometry = []
        for rij in (rij_list[a] for a in self._arrays):
            X = coarray(np.asarray(rij, dtype=np.float64))[0]
            g = state_from_numpy(self.base._host_solve_constants(X))
            self._geometry.append(self.base._solve_constants(
                {k: v.to(self.device) for k, v in g.items()}))

    def run_raw(self, data: np.ndarray) -> Dict[str, torch.Tensor]:
        """data: (A, C, T) -> dict of (A, B, Wmax) device tensors (``flags``
        (A, B, Wmax, P) with LTS); on a mesh every rank returns all A."""
        base = self.base
        if len(data) != self.A:
            raise ValueError(f"expected {self.A} arrays, got {len(data)}")
        x = base._to_device(np.asarray(data)[self._arrays.start:self._arrays.stop])
        A_loc = len(self._arrays)
        y = torch.stack([base._filter(x[a]) for a in range(A_loc)])
        ca = self.merge_chunk_arrays
        outs = [base._delays_batched(y[i:i + ca]) for i in range(0, A_loc, ca)]
        tau, _, mdccm = (torch.cat(v) for v in zip(*outs))
        # the JAX program fuses the delays into the sweep only from one merge
        # chunk: it concatenates several chunks' delays first
        res = [base._solve_masked(tau[a], mdccm[a], self._geometry[a], fused=len(outs) == 1)
               for a in range(A_loc)]
        out = {k: torch.stack([r[k] for r in res]) for k in res[0]}
        if self.mesh is None or self.mesh.nt == 1:
            return out
        return {k: self._gather(v, k) for k, v in out.items()}

    def _gather(self, v: torch.Tensor, name: str) -> torch.Tensor:
        """This rank's arrays -> every time shard's, in array order, on the
        pipeline's device (gloo on the card: through explicit host copies)."""
        mesh = self.mesh
        flags = v.dtype == torch.bool
        parts = mesh.all_gather(v.to(torch.uint8) if flags else v, f"the arrays' {name}",
                                group=mesh.time_group)
        out = mesh.from_comm(torch.cat(parts), v.device, f"the arrays' {name}")
        return out.bool() if flags else out
