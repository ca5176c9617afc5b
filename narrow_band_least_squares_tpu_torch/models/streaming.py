"""Continuous-monitoring pipeline: segmented runs with checkpoint and resume.

Port of ``narrow_band_least_squares_tpu/models/streaming.py``.
`StreamingMonitor`:

- tiles a long waveform, or a feed of chunks, into fixed segments,
- runs them in batches on the halo-extended segment step
  (`parallel.ShardedNarrowBandPipeline`, one device or a process mesh),
  keeping the device queue ``dispatch_depth`` batches deep,
- persists each segment's dense results in the reference TSV format plus a
  compact .npz (flags, uncertainties) on one ordered writer thread,
- on ``resume`` skips segments whose .txt exists,
- masks non-finite solves instead of failing (`_nan_guard`),
- re-assembles everything for the monitoring figure (`read_all`).

A failed batch is re-run synchronously on the same device, up to
``max_retries`` times; a CUDA error (which may leave the context unusable)
is not retried, and never falls back to the CPU.

Across processes (a mesh of more than one rank) every rank runs the same
batches: rank 0 decides which segments are left to do and broadcasts it,
a dispatch is never retried on one rank alone (the step and the assembly
are collectives), so a failure propagates on every rank, and only rank 0
persists.
"""

from __future__ import annotations

import logging
import os
from collections import deque
from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from narrow_band_least_squares_tpu_torch.io.stream import ArrayStream
from narrow_band_least_squares_tpu_torch.io.textio import read_txtfile, write_txtfile
from narrow_band_least_squares_tpu_torch.utils.plan import NarrowBandPlan
from narrow_band_least_squares_tpu_torch.utils.timeutils import epoch_to_datenum

logger = logging.getLogger("nbls_torch.streaming")


def _nan_guard(arr: np.ndarray) -> np.ndarray:
    """Non-finite solves become zeros (masked, not fatal)."""
    return np.where(np.isfinite(arr), arr, 0.0)


def _device_fault(e: Exception) -> bool:
    """A CUDA error, which may leave the context unusable: not retried."""
    accel = getattr(torch, "AcceleratorError", None)
    return (accel is not None and isinstance(e, accel)) or "CUDA error" in str(e)


@dataclass
class SegmentRecord:
    start_epoch: float
    path_txt: str
    path_npz: str


class StreamingMonitor:
    """Segmented narrow-band monitoring with persistence and resume.

    Args:
        plan: per-segment plan (npts = segment length).
        rij: (2, N) array geometry [km].
        save_dir: directory for per-segment TSV/npz outputs.
        freqlist: band edges, written into every TSV row.
        mesh: a `parallel.mesh.Mesh`, or None for one device in one
            process (several processes need a mesh).
        max_retries: synchronous re-runs of a failed batch (one process).
        dispatch_segments: segments per device dispatch, rounded up to a
            multiple of the mesh's time shards; segments buffer across
            `submit` calls until a batch fills (`flush` pads out the
            remainder by repeating the last segment).
        device: keyword-only; ``None`` means ``"cuda"`` and raises without
            CUDA.
        pipe_kwargs: forwarded to `parallel.ShardedNarrowBandPipeline`
            (``xcorr_method``, ``matmul_precision``, ``transfer_dtype``,
            ...).
    """

    def __init__(
        self,
        plan: NarrowBandPlan,
        rij: np.ndarray,
        save_dir: str,
        freqlist: Sequence[float],
        filter_type: str = "cheby1",
        filter_order: int = 2,
        filter_ripple: float = 0.01,
        alpha: float = 1.0,
        mesh=None,
        max_retries: int = 1,
        dispatch_segments: int = 4,
        *,
        device=None,
        **pipe_kwargs,
    ):
        dist = torch.distributed
        if (mesh is None and dist.is_available() and dist.is_initialized()
                and dist.get_world_size() > 1):
            raise ValueError(
                "StreamingMonitor across processes needs a mesh over the process "
                "group (parallel.make_mesh); without one every process would "
                "run and persist the whole stream")
        from narrow_band_least_squares_tpu_torch.parallel.sharded import (
            ShardedNarrowBandPipeline,
        )

        self.pipe = ShardedNarrowBandPipeline(
            plan, rij, mesh,
            filter_type=filter_type, filter_order=filter_order,
            filter_ripple=filter_ripple, alpha=alpha, device=device,
            **pipe_kwargs,
        )
        self.plan = plan
        self.freqlist = list(freqlist)
        self.save_dir = save_dir
        self.max_retries = max_retries
        os.makedirs(save_dir, exist_ok=True)
        # a multiple of the time shards: each takes batch/nt segments
        self.pipe._require_mesh()
        nt = self.pipe.nt
        self.batch = nt * max(1, -(-int(dispatch_segments) // nt))
        self.mesh = self.pipe.mesh
        self._multiproc = self.mesh.world_size > 1
        self._writer = self.mesh.rank == 0

        self._inflight = deque()   # (device_out | None, x_ext, t0s, real)
        self._backlog: List = []   # [(data, offset | None, t0)]
        self._futures: List = []
        self._queued: set = set()  # start_epochs submitted, not yet persisted
        self._pool = None

    # ------------------------------------------------------------------
    def _seg_name(self, start_epoch: float) -> str:
        return f"nbls_{start_epoch:.0f}"

    def _seg_done(self, start_epoch: float) -> bool:
        return os.path.exists(
            os.path.join(self.save_dir, self._seg_name(start_epoch) + ".txt")
        )

    def segment_starts(self, st: ArrayStream) -> List[Tuple[int, float]]:
        """(sample_offset, start_epoch) of each whole segment in the stream."""
        Tseg = self.plan.npts
        n = st.npts // Tseg
        return [
            (k * Tseg, st.start_epoch + k * Tseg / st.fs) for k in range(n)
        ]

    # ------------------------------------------------------------------
    # submit() keeps the device queue ``dispatch_depth`` batches deep and
    # persistence runs on one ordered writer thread, so host I/O and the
    # segment feed overlap device work.  A batch is persisted only after
    # its device result is on the host, so resume stays exact.  flush()
    # drains everything and returns the records persisted since the last
    # flush.

    def _writer_pool(self):
        if self._pool is None:
            from concurrent.futures import ThreadPoolExecutor

            self._pool = ThreadPoolExecutor(max_workers=1)
        return self._pool

    def submit(
        self, st: ArrayStream, resume: bool = True, dispatch_depth: int = 2,
    ) -> int:
        """Queue every (not-yet-done) segment of a stream; returns the
        number of segments queued.  Blocks only to keep at most
        ``dispatch_depth`` batches in flight; call `flush` (or `process`) to
        collect SegmentRecords.  ``st.data`` is consumed before this call
        returns (sub-batch leftovers are snapshotted), so the caller may
        reuse its buffer.

        Across processes every rank must run the same batches, so rank 0's
        view of what is done (its resume scan and queue) is broadcast.
        """
        starts = self.segment_starts(st)
        todo = [not ((resume and self._seg_done(t0)) or t0 in self._queued)
                for _, t0 in starts]
        if self._multiproc:
            mask = torch.tensor(todo, dtype=torch.int32, device=self.mesh.comm_device())
            todo = self.mesh.broadcast_from_rank0(mask, "the resume mask").tolist()
        todo = [s for s, keep in zip(starts, todo) if keep]
        if not todo:
            return 0
        self._queued.update(t0 for _, t0 in todo)

        # Segments buffer as (stream data, offset) references until a batch
        # fills; the halo-extended batch is cut at dispatch (_extend_batch),
        # from the raw stream (zeros before sample 0), so non-contiguous
        # resume batches stay exact.  The references never outlive this
        # call: the sub-batch remainder is cut (snapshotted) before return.
        self._backlog.extend((st.data, off, t0) for off, t0 in todo)
        while len(self._backlog) >= self.batch:
            self._dispatch(self._backlog[: self.batch])
            del self._backlog[: self.batch]
            while len(self._inflight) > max(1, int(dispatch_depth)):
                self._drain_oldest()
        refs = [(i, it) for i, it in enumerate(self._backlog)
                if it[1] is not None]
        if refs:
            rows = self._extend_batch([it for _, it in refs])
            for (i, it), row in zip(refs, rows):
                self._backlog[i] = (row, None, it[2])
        return len(todo)

    def _extend_batch(self, items) -> np.ndarray:
        """Cut halo-extended rows for a dispatch batch, one call per
        contiguous same-stream run.  Items are (data, offset, t0);
        ``offset is None`` marks an already-extended row (the snapshotted
        sub-batch remainder of a previous submit)."""
        outs = []
        i = 0
        while i < len(items):
            data, off, _ = items[i]
            if off is None:
                outs.append(data[None])
                i += 1
                continue
            j = i
            offs = []
            while (j < len(items) and items[j][0] is data
                   and items[j][1] is not None):
                offs.append(items[j][1])
                j += 1
            outs.append(self.pipe.extend_segments(data, offs))
            i = j
        return outs[0] if len(outs) == 1 else np.concatenate(outs)

    def _dispatch(self, items):
        """One device dispatch of up to `self.batch` buffered segments."""
        real = len(items)
        t0s = [t for _, _, t in items]
        x_ext = self._extend_batch(items)
        if real < self.batch:
            # pad by repeating the last segment; padded outputs dropped
            pad = np.broadcast_to(
                x_ext[-1], (self.batch - real,) + x_ext.shape[1:]
            )
            x_ext = np.concatenate([x_ext, pad])
            t0s = t0s + [t0s[-1]] * (self.batch - real)
        if self._multiproc:
            # a collective: every rank dispatches, or the failure propagates
            self._inflight.append((self.pipe.run_extended_async(x_ext), x_ext, t0s, real))
            return
        try:
            dev = self.pipe.run_extended_async(x_ext)
        except Exception as e:
            if _device_fault(e):
                self._queued.difference_update(t0s[:real])
                raise
            logger.warning("segment dispatch failed: %s", e)
            dev = None
        self._inflight.append((dev, x_ext, t0s, real))

    def _drain_oldest(self):
        dev, x_ext, t0s, real = self._inflight.popleft()
        if self._multiproc:
            # the assembly is a collective: a retry on one rank would leave
            # the others waiting, so a failure propagates on every rank
            out = self.pipe.finalize_extended(dev)
            if not self._writer:
                # the resume scan is rank 0's: nothing to persist here
                self._queued.difference_update(t0s[:real])
                return
            self._persist_batch(out, t0s, real)
            return
        try:
            if dev is None:
                raise RuntimeError("dispatch failed")
            out = self.pipe.finalize_extended(dev)
        except Exception as e:
            if _device_fault(e):
                self._queued.difference_update(t0s[:real])
                raise
            # re-run the batch synchronously on the same device
            logger.warning("async segment batch failed (%s); retrying", e)
            try:
                out = self._run_with_retry(lambda: self.pipe.run_extended(x_ext))
            except Exception:
                # permanently failed: un-queue so a later submit retries
                self._queued.difference_update(t0s[:real])
                raise
        self._persist_batch(out, t0s, real)

    def _persist_batch(self, out, t0s, real: int):
        pool = self._writer_pool()
        for s in range(real):
            self._futures.append(
                pool.submit(self._persist_and_mark, out, s, t0s[s])
            )

    def flush(self) -> List[SegmentRecord]:
        """Dispatch the backlog remainder, drain in-flight batches, and
        return records since the last flush."""
        if self._backlog:
            self._dispatch(self._backlog)
            self._backlog = []
        while self._inflight:
            self._drain_oldest()
        futs, self._futures = self._futures, []
        done, first_err = [], None
        for f in futs:
            try:
                done.append(f.result())
            except Exception as e:  # keep draining; report the first
                first_err = first_err or e
        if first_err is not None:
            # attach the records that were persisted, so their paths survive
            first_err.records = done
            raise first_err
        return done

    def process(
        self, st: ArrayStream, resume: bool = True, dispatch_depth: int = 2,
    ) -> List[SegmentRecord]:
        """Run every (not-yet-done) segment of a stream and persist the
        results: `submit` + `flush`, blocking until everything of this
        stream (and anything still queued) is persisted."""
        self.submit(st, resume=resume, dispatch_depth=dispatch_depth)
        return self.flush()

    def close(self) -> List[SegmentRecord]:
        """Drain everything and stop the writer thread."""
        try:
            return self.flush()
        finally:
            if self._pool is not None:
                self._pool.shutdown(wait=True)
                self._pool = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def _run_with_retry(self, fn):
        last = None
        for attempt in range(self.max_retries + 1):
            try:
                return fn()
            except Exception as e:
                if _device_fault(e):
                    raise
                logger.warning("segment attempt %d failed: %s", attempt, e)
                last = e
        raise last

    def _persist_and_mark(self, out, s: int, t0: float) -> SegmentRecord:
        """Writer-thread persist; the segment stays in _queued until its
        file exists, so an overlapping re-submit cannot duplicate it.  On
        failure it is un-queued too: no file was written, so a later
        submit selects it again."""
        try:
            return self._persist_segment(out, s, t0)
        finally:
            self._queued.discard(t0)

    # ------------------------------------------------------------------
    def _persist_segment(self, out: Dict[str, np.ndarray], s: int,
                         t0: float) -> SegmentRecord:
        """Persist segment ``s`` of a batch result dict."""
        plan = self.plan
        width = plan.width
        B = plan.nbands

        def dense(name):
            a = np.zeros((B, width))
            a[:, : plan.max_windows] = _nan_guard(np.asarray(out[name][s]))
            return a

        t_array = np.zeros((B, width))
        for b, wp in enumerate(plan.windows):
            t_array[b, : wp.n_windows] = epoch_to_datenum(
                wp.end_times_epoch(t0, plan.fs)
            )
        flags = np.asarray(out["flags"][s]) if "flags" in out else None
        return self._write(dense("vel"), dense("baz"), dense("mdccm"),
                           dense("sig_tau"), t_array, flags, t0,
                           vel_uncert=dense("vel_uncert"),
                           baz_uncert=dense("baz_uncert"))

    def _write(self, vel, baz, mdccm, sig_tau, t_array, flags,
               t0: float, vel_uncert=None, baz_uncert=None) -> SegmentRecord:
        """Persist one segment: the npz sidecar first (atomic), the TSV last
        (atomic, `io.textio`).  The resume scan keys on the .txt, so its
        existence implies the whole segment is on disk; a process dying in
        here leaves at most a .tmp file and the segment is selected again."""
        name = self._seg_name(t0)
        path_npz = os.path.join(self.save_dir, name + ".npz")
        extra = {}
        if vel_uncert is not None:
            extra = {"vel_uncert": vel_uncert, "baz_uncert": baz_uncert}
        tmp_npz = path_npz + ".tmp.npz"   # np.savez appends .npz to a bare name
        np.savez_compressed(
            tmp_npz, vel=vel, baz=baz, mdccm=mdccm, sig_tau=sig_tau,
            t=t_array, flags=(flags if flags is not None else np.zeros(0)),
            num_compute=np.asarray(self.plan.num_compute_list), **extra,
        )
        os.replace(tmp_npz, path_npz)
        path_txt = write_txtfile(
            self.save_dir, name, vel, baz, mdccm, t_array,
            self.freqlist, self.plan.num_compute_list,
        )
        return SegmentRecord(t0, path_txt, path_npz)

    # ------------------------------------------------------------------
    def read_all(self, extras: bool = False):
        """Concatenate all persisted segments (sorted by time) into dense
        arrays shaped for the monitoring figure: ``(vel, baz, mdccm, t,
        num_compute_list)``.

        ``extras=True`` also reads each segment's .npz sidecar, what the TSV
        cannot carry, and returns a sixth element: a dict of ``sig_tau`` /
        ``vel_uncert`` / ``baz_uncert`` dense ``(B, width)`` arrays and, for
        LTS runs, the ``(B, width, P)`` ``flags``, concatenated with the
        same per-band valid-prefix layout as vel/baz.  A segment without a
        sidecar contributes NaNs (and all-False flags), so timelines stay
        aligned.
        """
        names = sorted(
            f[:-4] for f in os.listdir(self.save_dir)
            if f.startswith("nbls_") and f.endswith(".txt")
        )
        if not names:
            raise FileNotFoundError(f"no segments persisted in {self.save_dir}")
        segs = [read_txtfile(self.save_dir, n) for n in names]
        nums = np.stack([np.asarray(s[5]) for s in segs])   # (nseg, B)
        num_total = nums.sum(axis=0)
        B = segs[0][0].shape[0]
        width = int(num_total.max())
        vel, baz, mdccm, t = (np.zeros((B, width)) for _ in range(4))
        for b in range(B):
            pos = 0
            for si, s in enumerate(segs):
                n_seg = int(nums[si, b])
                for dst, src in ((vel, s[0]), (baz, s[1]), (mdccm, s[2]), (t, s[3])):
                    dst[b, pos : pos + n_seg] = src[b, :n_seg]
                pos += n_seg
        num_list = [int(v) for v in num_total]
        if not extras:
            return vel, baz, mdccm, t, num_list

        # read each sidecar's arrays once (an NpzFile decompresses on every
        # __getitem__) and close the handles
        zs = []
        for n in names:
            p = os.path.join(self.save_dir, n + ".npz")
            if not os.path.exists(p):
                logger.warning("segment %s has no .npz sidecar; extras "
                               "filled with NaN", n)
                zs.append(None)
                continue
            with np.load(p, allow_pickle=False) as z:
                zs.append({
                    k: z[k] for k in
                    ("sig_tau", "vel_uncert", "baz_uncert", "flags")
                    if k in z
                })
        sig_tau, vel_uncert, baz_uncert = (
            np.full((B, width), np.nan) for _ in range(3)
        )
        P = 0
        for z in zs:
            f = None if z is None else z.get("flags")
            if f is not None and f.ndim == 3:
                P = int(f.shape[-1])
                break
        flags = np.zeros((B, width, P), dtype=bool) if P else None
        for b in range(B):
            pos = 0
            for si, z in enumerate(zs):
                n_seg = int(nums[si, b])
                if z is not None:
                    if "sig_tau" in z:
                        sig_tau[b, pos : pos + n_seg] = z["sig_tau"][b, :n_seg]
                    if "vel_uncert" in z:
                        vel_uncert[b, pos : pos + n_seg] = (
                            z["vel_uncert"][b, :n_seg]
                        )
                        baz_uncert[b, pos : pos + n_seg] = (
                            z["baz_uncert"][b, :n_seg]
                        )
                    f = z.get("flags")
                    if flags is not None and f is not None and f.ndim == 3:
                        flags[b, pos : pos + n_seg] = f[b, :n_seg].astype(bool)
                pos += n_seg
        ex = {"sig_tau": sig_tau, "vel_uncert": vel_uncert,
              "baz_uncert": baz_uncert}
        if flags is not None:
            ex["flags"] = flags
        return vel, baz, mdccm, t, num_list, ex
