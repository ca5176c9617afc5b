"""Sharded narrow-band pipeline: time segments x bands over a process mesh.

Port of ``narrow_band_least_squares_tpu/parallel/sharded.py`` on
``torch.distributed``: one process per rank of a `parallel.mesh.Mesh`, each
running its own step on its own device (the JAX package's ``shard_map``
body), where the JAX package runs one program over all devices.

- **Time axis**: a long waveform is tiled into equal segments; time shard
  t takes the contiguous ``S/nt`` segments ``[t S/nt, (t+1) S/nt)``.  The
  IIR filter needs warm-up state across a cut, so each segment carries a
  left halo of one impulse length (0 for zero-phase filters).  The halo of
  a shard's first segment is the tail of the previous shard's last
  segment, sent to the right neighbour on the time group
  (`Mesh.send_right`, the JAX package's ``ppermute``); time shard 0
  receives zeros, the cold start of every single run.  Window grids
  restart per segment, so no window straddles a cut.
- **Band axis**: no communication.  Under band shards (``nb > 1``) bands
  are dealt in descending window-length order round robin ("snake
  dealing"), so the shards hold near-equal window lengths at each slot,
  and the band *slots* are bucketed by window length
  (`_build_slot_buckets`): a slot's template (window count and length) is
  the largest over the shards at that slot, and each row keeps its own
  length mask, lag bounds and hop.  A rank holds only its shard's rows
  (`_view`); the slot-template decomposition is kept so that the
  whole-band oracle (`run_reference_sequential`) computes what the ranks
  compute.  Without bucketing (``bucket_bands=False``, or 'fused'/'fft',
  which the JAX package sends to its ``"global"`` mode) bands are dealt
  contiguously and each shard runs the global window grid's rows: 'mxu' on
  the global DFT tables, any other method `ops.xcorr.cross_correlate`.
  At ``nb == 1`` (``"core"`` mode) a rank runs the base pipeline's step.
- **Assembly**: outputs are packed into one tensor (plus the LTS flags),
  all-gathered to every rank and put back into the plan's band order;
  every rank returns the full ``(S, B, Wmax)`` dict.

On each rank the ``S/nt`` segments of a dispatch run as one merged delay
batch: one lag-search launch per bucket ('mxu'; one ``fused_xcorr_bucket``
launch per bucket with 'fused' at ``nb == 1``).  The filter bank runs per
segment, so with 'fused' a segment's results are the same bits in any
batch.
"""

from __future__ import annotations

import logging
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from narrow_band_least_squares_tpu_torch.models.narrowband import NarrowBandPipeline
from narrow_band_least_squares_tpu_torch.ops import filters as F
from narrow_band_least_squares_tpu_torch.ops import xcorr as XC
from narrow_band_least_squares_tpu_torch.ops.windows import (
    bucket_by_cost,
    extract_windows,
    extract_windows_strided_rows,
    split_windows,
)
from narrow_band_least_squares_tpu_torch.parallel.mesh import Mesh
from narrow_band_least_squares_tpu_torch.utils.device import resolve_device
from narrow_band_least_squares_tpu_torch.utils.plan import NarrowBandPlan

logger = logging.getLogger("nbls_torch")


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
    """Segmented narrow-band processing over a (time, band) mesh.

    Args:
        plan: per-*segment* plan (npts = segment length in samples).
        rij: (2, N) element coordinates [km].
        mesh: a `parallel.mesh.Mesh` (`make_mesh`), or None.  None with
            ``mesh_shape=None`` is the 1x1 mesh of one process.  None with
            ``mesh_shape=(nt, nb)`` is a *virtual* mesh: only
            `run_reference_sequential` runs, the ranks' computation one
            after another in this process; `run` raises.
        halo: left-halo samples for IIR continuity across segment cuts;
            defaults to the filter bank's impulse length for causal filters
            and 0 for zero-phase.
        transfer_dtype: the wire dtype of `wire_dtype`.  bfloat16 is rounded
            on the host into a pinned buffer, copied without blocking, and
            cast back to float32 on the device before filtering.
        device: keyword-only; ``None`` means ``"cuda"`` and raises without
            CUDA.
        Remaining keywords are `NarrowBandPipeline`'s.  Under band shards
        'pallas' becomes 'mxu' (a warning) and ``window_method='patches'``
        becomes 'strided' (logged), as in the JAX package; 'fused' and
        'fft' run `ops.xcorr.cross_correlate` there, and with ``max_lag_s``
        raise ``ValueError`` (the JAX package fails there).
        ``subsample_delays`` refines the delays wherever the lag search is
        'mxu' (the base's, each slot bucket's and the global grid's).
    """

    # outputs stacked into one tensor before leaving the device: one copy
    # to the host (or one all-gather) per batch, plus one for the LTS flags
    _PACK_KEYS = ("vel", "baz", "mdccm", "sig_tau", "vel_uncert",
                  "baz_uncert")

    def __init__(
        self,
        plan: NarrowBandPlan,
        rij: np.ndarray,
        mesh: Optional[Mesh] = None,
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
        if mesh is None and mesh_shape is None:
            mesh = Mesh(1, 1)
        if mesh is None:
            self.nt, self.nb = int(mesh_shape[0]), int(mesh_shape[1])
        elif not isinstance(mesh, Mesh):
            raise TypeError(
                f"mesh must be a parallel.mesh.Mesh (make_mesh), got {type(mesh).__name__}")
        else:
            self.nt, self.nb = mesh.nt, mesh.nb
        self.mesh = mesh
        if plan.nbands % self.nb != 0:
            raise ValueError(
                f"{plan.nbands} bands not divisible by band shards {self.nb}")
        if self.nb > 1:
            if xcorr_method == "pallas":
                logger.warning("xcorr_method='pallas' is not supported under band "
                               "sharding; falling back to 'mxu'")
                xcorr_method = "mxu"
            if window_method == "patches":
                logger.info("band-sharded pipeline supports 'strided' or 'gather' "
                            "extraction; using 'strided'")
                window_method = "strided"
        self.bucket_bands = bool(bucket_bands) and xcorr_method in ("mxu", "pallas")
        if self.nb == 1:
            self._mode = "core"
        elif self.bucket_bands:
            self._mode = "bucket"
        else:
            self._mode = "global"
        if self._mode == "global" and xcorr_method != "mxu" and max_lag_s is not None:
            raise ValueError(
                f"xcorr_method={xcorr_method!r} under band shards runs the FFT "
                "cross-correlation, which the JAX package cannot cap with "
                "max_lag_s (it fails there); use xcorr_method='mxu'")

        self.device = resolve_device(device)
        # the rank's constants: at nb == 1 the base pipeline's, on the
        # device; under band shards the base is host precomputation only and
        # a rank holds its shard's rows (_view)
        self.base = NarrowBandPipeline(
            plan, rij,
            filter_type=filter_type, filter_order=filter_order,
            filter_ripple=filter_ripple, alpha=alpha,
            apply_filter=True, dtype=dtype, c_steps=c_steps,
            xcorr_method=xcorr_method, window_method=window_method,
            max_lag_s=max_lag_s, matmul_precision=matmul_precision,
            lts_candidate_chunk=lts_candidate_chunk,
            lts_funnel_k=lts_funnel_k, subsample_delays=subsample_delays,
            bucket_bands=self.bucket_bands and self.nb == 1,
            bucket_ratio=bucket_ratio, bucket_slack=bucket_slack,
            max_lts_candidates=max_lts_candidates,
            xcorr_chunk_mb=xcorr_chunk_mb, xcorr_lag_tile=xcorr_lag_tile,
            band_limit_db=band_limit_db,
            device=self.device if self._mode == "core" else "cpu",
        )
        self.plan = plan
        self.transfer_dtype = wire_dtype(transfer_dtype, self.base.dtype)

        L = self.base.state_dict()["h_bank"].shape[1]
        if halo is None:
            halo = 0 if self.base.zerophase else int(L)
        self.halo = int(halo)
        self.T_ext = plan.npts + self.halo
        self.nfft_ext = F.next_pow2(self.T_ext + L)

        # band dealing: deal[k, s] = the band of shard k at slot s; the
        # device band layout holds band deal[k, s] at position k*B_loc + s
        self.B_loc = plan.nbands // self.nb
        if self._mode == "bucket":
            order = np.argsort([-wp.winlensamp for wp in plan.windows], kind="stable")
            self._deal = order.reshape(self.B_loc, self.nb).T.copy()
        else:
            self._deal = np.arange(plan.nbands).reshape(self.nb, self.B_loc)
        self._band_perm = self._deal.reshape(-1)
        self._band_inv_perm = np.argsort(self._band_perm)
        self._identity_deal = bool(np.array_equal(self._band_perm,
                                                  np.arange(plan.nbands)))
        self._views: Dict[Tuple[int, ...], dict] = {}
        if self._mode != "core":
            base = self.base
            self._pairs = base._pairs.to(self.device)
            self._taper = base.state_dict()["taper"].to(self.device)
            self._geometry = {k: v.to(self.device) for k, v in base._geometry.items()}
        if self._mode == "bucket":
            max_lag = None if max_lag_s is None else int(max_lag_s * plan.fs)
            self._build_slot_buckets(max_lag, float(bucket_slack))
        elif self._mode == "global":
            self._build_global_tables()

    # ------------------------------------------------------------------
    def _build_slot_buckets(self, max_lag: Optional[int], slack: float):
        """Bucket the band *slots* by window length (the JAX package's
        `_build_slot_buckets`).  Slot s's template length and window count
        are the largest over the shards at that slot; each row ``k*Bg + i``
        (shard k, the bucket's i-th slot) keeps its band's own length mask,
        length, lag half-width and hop.  The bucket's table set
        (`ops.xcorr.band_tables` at the template length with ``max_lag``,
        band-limited over every band at its slots; on the device
        `ops.xcorr.lag_tables`, with every row's lag columns) is shared by
        the views."""
        plan, nb, deal = self.plan, self.nb, self._deal
        lens = np.array([wp.winlensamp for wp in plan.windows])
        nwin = np.array([wp.n_windows for wp in plan.windows])
        slot_len = lens[deal].max(axis=0)
        slot_win = nwin[deal].max(axis=0)
        groups = bucket_by_cost(slot_len, slot_win, slack=slack)
        base = self.base
        gather = base.window_method == "gather"
        self._slot_buckets: List[dict] = []
        self._bucket_tables: List[dict] = []
        for slots in groups:
            slots = np.asarray(slots, dtype=np.int64)
            Lg, Wg = int(slot_len[slots].max()), int(slot_win[slots].max())
            half = Lg - 1 if max_lag is None else min(int(max_lag), Lg - 1)
            Bg = len(slots)
            len_mask = np.zeros((nb * Bg, Lg))
            lengths = np.zeros((nb * Bg,))
            lag_half = np.zeros((nb * Bg,), dtype=np.int64)
            hops = np.zeros((nb * Bg,), dtype=np.int64)
            idx = np.zeros((nb * Bg, Wg, Lg), dtype=np.int32) if gather else None
            for k in range(nb):
                for i, s in enumerate(slots):
                    wp = plan.windows[int(deal[k, s])]
                    Lb, r = wp.winlensamp, k * Bg + i
                    lengths[r] = Lb
                    len_mask[r, :Lb] = 1.0
                    lag_half[r] = min(Lb - 1, half)
                    hops[r] = wp.hop
                    if gather:
                        for w, s0 in enumerate(wp.starts):
                            idx[r, w, :Lb] = s0 + np.arange(Lb)
                            idx[r, w, Lb:] = s0
            bands = sorted(int(deal[k, s]) for k in range(nb) for s in slots)
            tab = XC.band_tables(Lg, half, bands, plan, base.sos_list, base.band_limit_db,
                                 base.zerophase)
            self._bucket_tables.append(XC.lag_tables(
                dict(tab, lo=half - lag_half, hi=half + lag_half), self.device,
                base.matmul_precision))
            self._slot_buckets.append({
                "slots": slots, "Wg": Wg, "Lg": Lg,
                "len_mask": len_mask.reshape(nb * Bg, 1, 1, Lg),
                "lengths": lengths, "lag_half": lag_half, "hops": hops, "idx": idx,
            })

    def _build_global_tables(self):
        """The global grid's rows (band-sharded contiguously) and, with
        'mxu', the base's unbucketed table set on the device."""
        base, grid = self.base, self.base.grid
        if base.xcorr_method == "mxu":
            self._global_tables = XC.lag_tables(base._xtab["tables."], self.device,
                                                base.matmul_precision)
        self._global_rows = {
            "idx": grid.idx, "len_mask": grid.len_mask,
            "lengths": grid.lengths.astype(np.float64), "lag_mask": grid.lag_mask,
        }

    def _bucket_gathers(self, shards: Sequence[int]) -> np.ndarray:
        """The permutation that takes the concatenated bucket outputs of a
        view (shards ``shards``, rows shard-major per bucket) to the view's
        band layout, where position ``j*B_loc + s`` holds band
        ``deal[shards[j], s]``."""
        rows = [np.concatenate([j * self.B_loc + bk["slots"] for j in range(len(shards))])
                for bk in self._slot_buckets]
        return np.argsort(np.concatenate(rows), kind="stable")

    def _view(self, shards: Sequence[int]) -> dict:
        """The constants of the band shards ``shards`` on the device: a
        rank's own (one shard) or the whole band axis (the oracle), built
        once each."""
        key = tuple(int(k) for k in shards)
        if key in self._views:
            return self._views[key]
        dev, B_loc = self.device, self.B_loc
        st = self.base.state_dict()
        bands = np.concatenate([self._band_perm[k * B_loc:(k + 1) * B_loc] for k in key])
        rows = torch.as_tensor(bands, dtype=torch.int64)
        v = {"h_bank": st["h_bank"][rows].to(dev), "win_mask": st["win_mask"][rows].to(dev)}
        f32 = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32).to(dev)
        i32 = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.int32).to(dev)
        if self._mode == "bucket":
            v["buckets"] = []
            for bk, tab in zip(self._slot_buckets, self._bucket_tables):
                Bg = len(bk["slots"])
                r = np.concatenate([k * Bg + np.arange(Bg) for k in key])
                rt = torch.as_tensor(r, device=dev)
                slot_rows = np.concatenate([j * B_loc + bk["slots"] for j in range(len(key))])
                v["buckets"].append({
                    "rows": torch.as_tensor(slot_rows, dtype=torch.int64, device=dev),
                    "row_list": slot_rows.tolist(), "hops": bk["hops"][r],
                    "len_mask": f32(bk["len_mask"][r]), "lengths": f32(bk["lengths"][r]),
                    "lo": tab["lo"][rt], "hi": tab["hi"][rt],
                    **({"idx": i32(bk["idx"][r])} if bk["idx"] is not None else {}),
                })
            v["inv"] = torch.as_tensor(self._bucket_gathers(key), dtype=torch.int64,
                                       device=dev)
        else:
            g = self._global_rows
            v.update(idx=i32(g["idx"][bands]), len_mask=f32(g["len_mask"][bands]),
                     lengths=f32(g["lengths"][bands]),
                     lag_mask=torch.as_tensor(g["lag_mask"][bands]).to(dev))
            if self.base.xcorr_method == "mxu":
                bt = torch.as_tensor(bands, device=dev)
                v.update(lo=self._global_tables["lo"][bt], hi=self._global_tables["hi"][bt])
        self._views[key] = v
        return v

    # ------------------------------------------------------------------
    def _segment_step(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        """``"core"`` mode: halo-extended segments (S, C, T_ext), any wire
        dtype, on the device -> dict of (S, B, Wmax) outputs (``flags``
        (S, B, Wmax, P) with LTS)."""
        base = self.base
        # the filter bank one segment at a time: cuFFT's bits for a row may
        # depend on the batch count, and a segment's result must not depend
        # on the batch it rode in (a resumed segment rewrites its files)
        y = torch.stack([base._filter(seg, nfft=self.nfft_ext, halo=self.halo)
                         for seg in x])                   # (S, B, C, Tseg)
        tau, _, mdccm = base._delays_merged(y)
        outs = [base._solve_masked(t, m) for t, m in zip(tau, mdccm)]
        return {k: torch.stack([o[k] for o in outs]) for k in outs[0]}

    def _view_step(self, x: torch.Tensor, v: dict) -> Dict[str, torch.Tensor]:
        """Band shards: segments (S, C, T_ext) on the device -> dict of
        (S, B_view, Wmax) outputs in the view's band layout.  The S segments
        share one lag search per slot bucket (or one over the grid)."""
        base, plan = self.base, self.plan
        S, Wmax = x.shape[0], plan.max_windows
        ys = [F.filter_bank_fft(seg.to(base.dtype), v["h_bank"], None, self.nfft_ext,
                                base.zerophase)[..., self.halo:] * self._taper
              for seg in x]                                # S x (B_view, C, Tseg)
        prec, sub = base.matmul_precision, base.subsample_delays
        if self._mode == "bucket":
            taus, mds = [], []
            for bk, tab, bc in zip(self._slot_buckets, self._bucket_tables, v["buckets"]):
                Wg, Lg = bk["Wg"], bk["Lg"]
                if "idx" in bc:
                    wins = [extract_windows(y[bc["rows"]], bc["idx"], bc["len_mask"],
                                            bc["lengths"]) for y in ys]
                else:
                    wins = [extract_windows_strided_rows(y, bc["row_list"], bc["hops"], Wg,
                                                         Lg, bc["len_mask"], bc["lengths"])
                            for y in ys]
                win = wins[0] if S == 1 else torch.cat(wins, dim=1)
                tau, _, md = XC.cross_correlate_bounds(win, self._pairs, bc["lo"], bc["hi"],
                                                       tab, plan.fs, prec, sub)
                taus.append(split_windows(tau, S, Wmax))
                mds.append(split_windows(md, S, Wmax))
            tau = torch.cat(taus, dim=1)[:, v["inv"]]
            mdccm = torch.cat(mds, dim=1)[:, v["inv"]]
        else:
            wins = [extract_windows(y, v["idx"], v["len_mask"], v["lengths"]) for y in ys]
            win = wins[0] if S == 1 else torch.cat(wins, dim=1)
            if base.xcorr_method == "mxu":
                tau, _, md = XC.cross_correlate_bounds(win, self._pairs, v["lo"], v["hi"],
                                                       self._global_tables, plan.fs, prec,
                                                       sub)
            else:
                tau, _, md = XC.cross_correlate(win, self._pairs, v["lag_mask"],
                                                base.nfft_corr, plan.fs)
            tau, mdccm = split_windows(tau, S, Wmax), split_windows(md, S, Wmax)
        outs = [base._solve_masked(t, m, self._geometry, v["win_mask"])
                for t, m in zip(tau, mdccm)]
        return {k: torch.stack([o[k] for o in outs]) for k in outs[0]}

    def _rank_step(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        if self._mode == "core":
            return self._segment_step(x)
        return self._view_step(x, self._view([self.mesh.b]))

    # ------------------------------------------------------------------
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

    def _require_mesh(self):
        if self.mesh is None:
            raise RuntimeError(
                "this pipeline was built with mesh=None and a mesh_shape (a "
                "virtual mesh: run_reference_sequential only); pass a "
                "parallel.mesh.Mesh (make_mesh) to execute run()/"
                "run_extended()/StreamingMonitor")

    def _local_rows(self, S: int) -> slice:
        if S % self.nt:
            raise ValueError(f"{S} segments are not a multiple of the "
                             f"{self.nt} time shards")
        S_loc = S // self.nt
        return slice(self.mesh.t * S_loc, (self.mesh.t + 1) * S_loc)

    def _pack(self, out: Dict[str, torch.Tensor], host) -> Dict[str, torch.Tensor]:
        res = {"packed": torch.stack([out[k] for k in self._PACK_KEYS]), "wire": host}
        if "flags" in out:
            res["flags"] = out["flags"]
        return res

    def run_extended(self, x_ext: np.ndarray) -> Dict[str, np.ndarray]:
        """Execute on host-extended segments (S, C, halo+Tseg); S % nt == 0."""
        return self.finalize_extended(self.run_extended_async(x_ext))

    def run_extended_async(self, x_ext: np.ndarray) -> Dict[str, torch.Tensor]:
        """Queue `run_extended` on the device without waiting for it.

        Each rank takes its time shard's rows of ``x_ext`` (the host cut
        every halo, so nothing is sent).  Returns ``packed`` (6, S/nt,
        B/nb, Wmax), this rank's outputs of ``_PACK_KEYS`` stacked, and with
        LTS ``flags`` (S/nt, B/nb, Wmax, P), both on the pipeline's device,
        and ``wire``, the host buffer the copy reads, held until
        `finalize_extended` (which assembles every rank's).  Lets a caller
        overlap the next batch's host work with this batch's device work
        (the streaming monitor's device queue).
        """
        self._require_mesh()
        host, x = self._to_wire(x_ext[self._local_rows(len(x_ext))])
        return self._pack(self._rank_step(x), host)

    def finalize_extended(self, out: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
        """Wait for a `run_extended_async` result and assemble it on the
        host: every rank's block all-gathered (one gather of the packed
        tensor, one of the flags), in the plan's band order."""
        packed = self._assemble(out["packed"], 1, "the packed outputs")
        res = {k: packed[i] for i, k in enumerate(self._PACK_KEYS)}
        if "flags" in out:
            res["flags"] = self._assemble(out["flags"].to(torch.uint8), 0,
                                          "the LTS flags").astype(bool)
        return self._unpermute_bands(res)

    def _assemble(self, block: torch.Tensor, seg_axis: int, what: str) -> np.ndarray:
        """Every rank's (..., S/nt, B/nb, ...) block -> the (..., S, B, ...)
        host array in the device band layout (block (t, b) at segments
        t*S/nt and band positions b*B/nb)."""
        blocks = [b.cpu().numpy() for b in self.mesh.all_gather(block, what)]
        if len(blocks) == 1:
            return blocks[0]
        nb = self.nb
        rows = [np.concatenate(blocks[t * nb:(t + 1) * nb], axis=seg_axis + 1)
                for t in range(self.nt)]
        return np.concatenate(rows, axis=seg_axis)

    def _unpermute_bands(self, out: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        """Device (dealt) band layout -> the plan's band order (axis 1)."""
        if self._identity_deal:
            return out
        inv = self._band_inv_perm
        return {k: v[:, inv] for k, v in out.items()}

    # ------------------------------------------------------------------
    def segment_stream(self, data: np.ndarray) -> np.ndarray:
        """(C, T_total) -> (S, C, Tseg); trims the remainder.  S is rounded
        down to a multiple of the time-shard count."""
        C, T = data.shape
        Tseg = self.plan.npts
        S = (T // Tseg // self.nt) * self.nt
        if S == 0:
            raise ValueError(
                f"stream of {T} samples is shorter than one {Tseg}-sample "
                f"segment per time shard ({self.nt} shards)")
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
        """Execute on (S, C, Tseg) contiguous segments, S % nt == 0; every
        rank returns the host numpy dict of (S, B, Wmax) outputs plus flags
        (S, B, Wmax, P) with LTS.

        Time shard t takes segments ``[t S/nt, (t+1) S/nt)``; the halo of
        its first one comes from time shard t-1 (`Mesh.send_right`), the
        others' from its own segments, all on the device.
        """
        self._require_mesh()
        host, x = self._to_wire(segments[self._local_rows(len(segments))])
        if self.halo > 0:
            cut = self.plan.npts - self.halo
            recv = self.mesh.send_right(x[-1, :, cut:])
            tails = torch.cat([recv[None], x[:-1, :, cut:]], dim=0)
            x = torch.cat([tails, x], dim=-1)
        return self.finalize_extended(self._pack(self._rank_step(x), host))

    def run_reference_sequential(self, segments: np.ndarray) -> Dict[str, np.ndarray]:
        """The oracle for `run`, in one process: the same halo chaining on
        the host, and each time shard's batch of ``S/nt`` segments one after
        another through the same step over the whole band axis (the
        slot-bucket decomposition of every band shard at once).  At
        ``nb == 1`` that is each rank's own computation, so equal to `run`
        bit for bit."""
        x_ext = self._chain_halos(segments)
        S_loc = len(x_ext) // self.nt
        if len(x_ext) % self.nt:
            raise ValueError(f"{len(x_ext)} segments are not a multiple of the "
                             f"{self.nt} time shards")
        outs = []
        for t in range(self.nt):
            _, x = self._to_wire(x_ext[t * S_loc:(t + 1) * S_loc])
            out = (self._segment_step(x) if self._mode == "core"
                   else self._view_step(x, self._view(range(self.nb))))
            res = {k: out[k].cpu().numpy() for k in self._PACK_KEYS}
            if "flags" in out:
                res["flags"] = out["flags"].cpu().numpy()
            outs.append(res)
        return self._unpermute_bands(
            {k: np.concatenate([o[k] for o in outs]) for k in outs[0]})
