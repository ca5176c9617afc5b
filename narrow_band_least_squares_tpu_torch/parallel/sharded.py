"""The halo-extended segment step: a long waveform as equal segments.

Port of ``narrow_band_least_squares_tpu/parallel/sharded.py`` on one
device, the JAX package's mesh of one time shard and one band shard (its
``"core"`` mode).  A long waveform is tiled into equal segments and each is
processed like one run of `models.NarrowBandPipeline`.  The IIR filter
needs warm-up state across a cut, so each segment carries a left halo of
one impulse length (0 for zero-phase filters) cut from the samples before
it, zeros before sample 0: segment 0 is the cold start every single run
has.  Window grids restart per segment, so no window straddles a cut.

The S segments of one dispatch run as one merged delay batch
(`NarrowBandPipeline._delays_merged`, as `models.MultiArrayPipeline` merges
arrays): one ``icorr_peak`` launch per window-length bucket with 'mxu', one
``fused_xcorr_bucket`` launch per bucket with 'fused'; then each segment is
solved with the base geometry.  The filter bank runs per segment, so with
'fused' a segment's results are the same bits in any batch.  Outputs leave
the device packed in one tensor (plus the LTS flags).

Meshes of more than one device wait for ROADMAP.md Queue 1 item 6.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from narrow_band_least_squares_tpu_torch.models.narrowband import (
    NarrowBandPipeline,
    _not_ported,
)
from narrow_band_least_squares_tpu_torch.ops import filters as F
from narrow_band_least_squares_tpu_torch.utils.plan import NarrowBandPlan


def wire_dtype(transfer_dtype, dtype=torch.float32) -> torch.dtype:
    """The host-to-device dtype of segment samples: ``None`` (or ``dtype``)
    means the pipeline's ``dtype`` (exact); ``'bfloat16'`` (or ``'bf16'``)
    halves the bytes a batch ships and rounds each sample to 8 mantissa
    bits."""
    if transfer_dtype in ("bfloat16", "bf16"):
        return torch.bfloat16
    if transfer_dtype is None or transfer_dtype == dtype:
        return dtype
    raise ValueError(f"unknown transfer_dtype {transfer_dtype!r}")


class ShardedNarrowBandPipeline:
    """Segmented narrow-band processing with halo-extended segments.

    Args:
        plan: per-*segment* plan (npts = segment length in samples).
        rij: (2, N) element coordinates [km].
        mesh: None (one device).  ``mesh_shape`` may be None or (1, 1).
            Any other mesh raises ``NotImplementedError``.
        halo: left-halo samples for IIR continuity across segment cuts;
            defaults to the filter bank's impulse length for causal filters
            and 0 for zero-phase.
        transfer_dtype: the wire dtype of `wire_dtype`.  bfloat16 is rounded
            on the host into a pinned buffer, copied without blocking, and
            cast back to float32 on the device before filtering.
        device: keyword-only; ``None`` means ``"cuda"`` and raises without
            CUDA.
        Remaining keywords are `NarrowBandPipeline`'s and pass through to
        the base pipeline unchanged (``xcorr_method``, ``matmul_precision``,
        ``lts_funnel_k``, ...).  ``bucket_ratio``, ``xcorr_chunk_mb`` and
        ``xcorr_lag_tile`` change nothing, as there.
    """

    # outputs stacked into one tensor before leaving the device: one copy
    # to the host per batch (plus one for the LTS flags)
    _PACK_KEYS = ("vel", "baz", "mdccm", "sig_tau", "vel_uncert",
                  "baz_uncert")

    def __init__(
        self,
        plan: NarrowBandPlan,
        rij: np.ndarray,
        mesh=None,
        filter_type: str = "cheby1",
        filter_order: int = 2,
        filter_ripple: float = 0.01,
        alpha: float = 1.0,
        dtype=torch.float32,
        c_steps: int = 4,
        halo: Optional[int] = None,
        xcorr_method: str = "mxu",
        window_method: str = "strided",
        max_lag_s: Optional[float] = None,
        matmul_precision: str = "high",
        lts_candidate_chunk: int = 0,
        lts_funnel_k: int = 0,
        subsample_delays: bool = False,
        bucket_bands: bool = True,
        bucket_ratio: float = 1.3,
        bucket_slack: float = 1.08,
        max_lts_candidates: int = 0,
        xcorr_chunk_mb: float = 16.0,
        xcorr_lag_tile: int = 512,
        band_limit_db=0.0,
        mesh_shape: Optional[Tuple[int, int]] = None,
        transfer_dtype=None,
        *,
        device=None,
    ):
        if mesh is not None or mesh_shape not in (None, (1, 1), [1, 1]):
            raise _not_ported(
                f"ShardedNarrowBandPipeline on a mesh other than one device "
                f"(mesh={mesh!r}, mesh_shape={mesh_shape!r})", "Queue 1 item 6")
        self.base = NarrowBandPipeline(
            plan, rij,
            filter_type=filter_type, filter_order=filter_order,
            filter_ripple=filter_ripple, alpha=alpha,
            apply_filter=True, dtype=dtype, c_steps=c_steps,
            xcorr_method=xcorr_method, window_method=window_method,
            max_lag_s=max_lag_s, matmul_precision=matmul_precision,
            lts_candidate_chunk=lts_candidate_chunk,
            lts_funnel_k=lts_funnel_k, subsample_delays=subsample_delays,
            bucket_bands=bucket_bands, bucket_ratio=bucket_ratio,
            bucket_slack=bucket_slack, max_lts_candidates=max_lts_candidates,
            xcorr_chunk_mb=xcorr_chunk_mb, xcorr_lag_tile=xcorr_lag_tile,
            band_limit_db=band_limit_db, device=device,
        )
        self.device = self.base.device
        self.plan = plan
        self.transfer_dtype = wire_dtype(transfer_dtype, dtype)

        L = self.base.state_dict()["h_bank"].shape[1]
        if halo is None:
            halo = 0 if self.base.zerophase else int(L)
        self.halo = int(halo)
        self.T_ext = plan.npts + self.halo
        self.nfft_ext = F.next_pow2(self.T_ext + L)

    # ------------------------------------------------------------------
    def _segment_step(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Halo-extended segments (S, C, T_ext), any wire dtype, on the
        device -> dict of (S, B, Wmax) outputs (``flags`` (S, B, Wmax, P)
        with LTS)."""
        base = self.base
        # the filter bank one segment at a time: cuFFT's bits for a row may
        # depend on the batch count, and a segment's result must not depend
        # on the batch it rode in (a resumed segment rewrites its files)
        y = torch.stack([base._filter(seg, nfft=self.nfft_ext, halo=self.halo)
                         for seg in x])                   # (S, B, C, Tseg)
        tau, _, mdccm = base._delays_merged(y)
        outs = [base._solve_masked(t, m) for t, m in zip(tau, mdccm)]
        return {k: torch.stack([o[k] for o in outs]) for k in outs[0]}

    def extend_segments(self, data: np.ndarray, offsets) -> np.ndarray:
        """Cut halo-extended segments (S, C, halo+Tseg) at given offsets.

        Halos come from the raw stream itself (zeros before sample 0), so
        any subset of segments, contiguous or not, is processed with the
        same warm filter state as a full run.  Returns float32: a bfloat16
        wire is rounded at dispatch (`run_extended_async`).
        """
        C, T = data.shape
        Tseg, halo = self.plan.npts, self.halo
        out = np.zeros((len(offsets), C, halo + Tseg), dtype=np.float32)
        for i, off in enumerate(offsets):
            lo = max(0, off - halo)
            out[i, :, halo - (off - lo):halo] = data[:, lo:off]
            out[i, :, halo:] = data[:, off : off + Tseg]
        return out

    def _to_wire(self, x_ext) -> Tuple[torch.Tensor, torch.Tensor]:
        """(host buffer, device tensor) of the segments in the wire dtype.
        On the card the host buffer is pinned and the copy does not block;
        the buffer must live until the copy ends (`finalize_extended`)."""
        x = torch.from_numpy(np.ascontiguousarray(x_ext, dtype=np.float32))
        if self.device.type != "cuda":
            host = x.to(self.transfer_dtype)
            return host, host.to(self.device)
        host = torch.empty(x.shape, dtype=self.transfer_dtype, pin_memory=True)
        host.copy_(x)                      # rounds to the nearest even on the host
        return host, host.to(self.device, non_blocking=True)

    def run_extended(self, x_ext: np.ndarray) -> Dict[str, np.ndarray]:
        """Execute on host-extended segments (S, C, halo+Tseg)."""
        return self.finalize_extended(self.run_extended_async(x_ext))

    def run_extended_async(self, x_ext: np.ndarray) -> Dict[str, torch.Tensor]:
        """Queue `run_extended` on the device without waiting for it.

        Returns ``packed`` (6, S, B, Wmax), the outputs of ``_PACK_KEYS``
        stacked, and with LTS ``flags`` (S, B, Wmax, P), both on the
        pipeline's device, and ``wire``, the host buffer the copy reads,
        held until `finalize_extended`.  Lets a caller overlap the next
        batch's host work with this batch's device work (the streaming
        monitor's device queue).
        """
        host, x = self._to_wire(x_ext)
        out = self._segment_step(x)
        res = {"packed": torch.stack([out[k] for k in self._PACK_KEYS]),
               "wire": host}
        if "flags" in out:
            res["flags"] = out["flags"]
        return res

    def finalize_extended(self, out: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
        """Wait for a `run_extended_async` result and copy it to the host:
        one copy of the packed tensor, one of the flags."""
        packed = out["packed"].cpu().numpy()
        res = {k: packed[i] for i, k in enumerate(self._PACK_KEYS)}
        if "flags" in out:
            res["flags"] = out["flags"].cpu().numpy()
        return res

    # ------------------------------------------------------------------
    def segment_stream(self, data: np.ndarray) -> np.ndarray:
        """(C, T_total) -> (S, C, Tseg); trims the remainder."""
        C, T = data.shape
        Tseg = self.plan.npts
        S = T // Tseg
        if S == 0:
            raise ValueError(
                f"stream of {T} samples is shorter than one {Tseg}-sample segment"
            )
        x = data[:, : S * Tseg].reshape(C, S, Tseg).transpose(1, 0, 2)
        return np.ascontiguousarray(x)

    def _chain_halos(self, segments: np.ndarray) -> np.ndarray:
        """Contiguous segments (S, C, Tseg) -> (S, C, halo+Tseg): each halo
        the tail of the segment before it, zeros for segment 0."""
        S, C, Tseg = segments.shape
        halo = self.halo
        x_ext = np.zeros((S, C, halo + Tseg), dtype=np.float32)
        for s in range(S):
            if halo > 0 and s > 0:
                x_ext[s, :, :halo] = segments[s - 1][:, Tseg - halo:]
            x_ext[s, :, halo:] = segments[s]
        return x_ext

    def run(self, segments: np.ndarray) -> Dict[str, np.ndarray]:
        """Execute on (S, C, Tseg) contiguous segments in one batch; returns
        a host numpy dict of (S, B, Wmax) outputs plus flags (S, B, Wmax, P)
        with LTS."""
        return self.run_extended(self._chain_halos(segments))

    def run_reference_sequential(self, segments: np.ndarray) -> Dict[str, np.ndarray]:
        """The oracle for `run`: the same halo chaining, one segment per
        step."""
        outs = [self.run_extended(x[None]) for x in self._chain_halos(segments)]
        return {k: np.concatenate([o[k] for o in outs]) for k in outs[0]}
