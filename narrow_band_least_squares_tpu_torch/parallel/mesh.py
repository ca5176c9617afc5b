"""Process meshes for the narrow-band workload on ``torch.distributed``.

Port of ``narrow_band_least_squares_tpu/parallel/mesh.py``.  The
workload's two scaling axes are contiguous **time segments** and
**frequency bands**.  In the JAX package both are axes of one
single-controller ``jax.sharding.Mesh``; here each rank is a process
running its own step on its own device, and a `Mesh` is a grid of ranks::

    rank = t * nb + b          (t: time shard, b: band shard)

laid out by ``torch.distributed.device_mesh.init_device_mesh`` with the
dimension names ``("time", "band")``.  A time shard sends the filter halo
to its right neighbour on its time group (`Mesh.send_right`); band shards
share nothing but the final assembly (`Mesh.all_gather`).  A 1x1 `Mesh`
needs no process group: one process runs the same code without
``init_process_group``.

Backends: NCCL takes CUDA tensors and gloo CPU tensors.  Under NCCL a CPU
tensor in a collective raises; nothing is copied quietly.  Under gloo with
the pipeline on the card, every tensor a collective moves is copied to the
host and back explicitly, logged once per kind and counted in
`Mesh.stats` (bytes and seconds).
"""

from __future__ import annotations

import logging
import os
import time
from dataclasses import dataclass, field
from datetime import timedelta
from typing import List, Optional, Tuple

import torch
import torch.distributed as dist

TIME_AXIS = "time"
BAND_AXIS = "band"
# how long a collective waits for a rank before the process group fails it
COLLECTIVE_TIMEOUT = timedelta(seconds=600)

logger = logging.getLogger("nbls_torch.parallel")


def auto_mesh_shape(
    n_devices: int, nbands: Optional[int] = None,
    min_bands_per_shard: int = 6,
) -> Tuple[int, int]:
    """Pick (time_shards, band_shards) for n devices (the JAX package's
    arithmetic).

    Band sharding needs no communication but pays slot-template padding:
    each slot's shapes are the largest over the ``nb`` bands dealt to it.
    Time sharding costs only the halo.  So: the largest band-shard count
    that keeps at least ``min_bands_per_shard`` bands per shard (dense
    sweeps), else time shards (the canonical 8 bands on 8 devices ->
    (8, 1)).
    """
    nb = 1
    if nbands:
        for cand in range(min(n_devices, nbands), 0, -1):
            if (
                n_devices % cand == 0
                and nbands % cand == 0
                and (cand == 1 or nbands // cand >= min_bands_per_shard)
            ):
                nb = cand
                break
    nt = n_devices // nb
    return nt, nb


@dataclass
class CommStats:
    """What a mesh's collectives moved since the stats were last reset."""

    halo_bytes: int = 0          # sent to the right neighbour
    gather_bytes: int = 0        # this rank's contribution to all-gathers
    broadcast_bytes: int = 0
    host_copy_bytes: int = 0     # gloo with the pipeline on the card
    host_copy_s: float = 0.0
    kinds: set = field(default_factory=set)   # host copies already logged


class Mesh:
    """A (time, band) grid of ranks.

    ``t`` and ``b`` are this rank's coordinates, ``time_group`` the ranks of
    its band shard across time (its halo neighbours), ``band_group`` the
    ranks of its time shard across bands.  Without a device mesh it is the
    1x1 mesh of one process: no process group, every collective a no-op.
    """

    def __init__(self, time_shards: int = 1, band_shards: int = 1, device_mesh=None):
        self.nt, self.nb = int(time_shards), int(band_shards)
        self.shape = {TIME_AXIS: self.nt, BAND_AXIS: self.nb}
        self.device_mesh = device_mesh
        self.stats = CommStats()
        if device_mesh is None:
            if self.nt * self.nb != 1:
                raise ValueError("a mesh of more than one rank needs a device mesh")
            self.rank, self.t, self.b = 0, 0, 0
            self.time_group = self.band_group = None
            self.backend = None
        else:
            self.rank = dist.get_rank()
            self.t, self.b = (int(c) for c in device_mesh.get_coordinate())
            self.time_group = device_mesh.get_group(TIME_AXIS)
            self.band_group = device_mesh.get_group(BAND_AXIS)
            self.backend = str(dist.get_backend())

    def reset_stats(self) -> None:
        self.stats = CommStats(kinds=self.stats.kinds)

    @property
    def world_size(self) -> int:
        return self.nt * self.nb

    @property
    def distributed(self) -> bool:
        """True on a process group (even of one rank)."""
        return self.device_mesh is not None

    def __repr__(self) -> str:
        return (f"Mesh(time={self.nt}, band={self.nb}, rank={self.rank}, "
                f"t={self.t}, b={self.b}, backend={self.backend})")

    # ------------------------------------------------------------------
    def comm_device(self) -> torch.device:
        """Where a tensor made on the host for a collective goes: the card
        under NCCL, the host under gloo (or without a process group)."""
        if self.backend == "nccl":
            return torch.device("cuda", torch.cuda.current_device())
        return torch.device("cpu")

    def to_comm(self, t: torch.Tensor, what: str) -> torch.Tensor:
        """The tensor to hand this backend's collective (``what`` names it in
        the log and the error)."""
        if self.backend == "nccl":
            if t.device.type != "cuda":
                raise RuntimeError(
                    f"{what}: NCCL takes CUDA tensors, got one on {t.device} "
                    "(the port copies nothing to or from the host quietly; use "
                    "gloo for CPU tensors)")
            return t
        if t.device.type == "cpu":
            return t
        return self._host_copy(t, torch.device("cpu"), what)

    def from_comm(self, t: torch.Tensor, device: torch.device, what: str) -> torch.Tensor:
        """A collective's result back on ``device``."""
        if t.device == device or t.device.type == device.type == "cpu":
            return t
        return self._host_copy(t, device, what)

    def _host_copy(self, t: torch.Tensor, device: torch.device, what: str) -> torch.Tensor:
        """An explicit copy between the card and the host for gloo: timed
        (the copy is waited for), counted and logged once per kind."""
        if what not in self.stats.kinds:
            self.stats.kinds.add(what)
            logger.info("gloo on CUDA: %s goes through a host copy (%s -> %s)",
                        what, t.device, device)
        t0 = time.perf_counter()
        out = t.to(device)
        if t.device.type == "cuda" or device.type == "cuda":
            torch.cuda.synchronize()
        self.stats.host_copy_s += time.perf_counter() - t0
        self.stats.host_copy_bytes += t.numel() * t.element_size()
        return out

    # ------------------------------------------------------------------
    def send_right(self, tail: torch.Tensor) -> torch.Tensor:
        """Send ``tail`` to time shard t+1 and return what time shard t-1
        sent (zeros at t = 0: the cold start), on ``tail``'s device."""
        if self.nt == 1:
            return torch.zeros_like(tail)
        send = self.to_comm(tail.contiguous(), "the halo")
        recv = torch.zeros_like(send)
        grp = self.time_group
        ops = []
        if self.t + 1 < self.nt:
            ops.append(dist.P2POp(dist.isend, send,
                                  dist.get_global_rank(grp, self.t + 1), group=grp))
            self.stats.halo_bytes += send.numel() * send.element_size()
        if self.t > 0:
            ops.append(dist.P2POp(dist.irecv, recv,
                                  dist.get_global_rank(grp, self.t - 1), group=grp))
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return self.from_comm(recv, tail.device, "the halo")

    def all_gather(self, t: torch.Tensor, what: str, group=None) -> List[torch.Tensor]:
        """Every rank's ``t`` (of the world, or of ``group``), in rank order,
        on the backend's device (the host under gloo)."""
        if not self.distributed:
            return [t]
        send = self.to_comm(t.contiguous(), what)
        n = dist.get_world_size(group)
        out = [torch.empty_like(send) for _ in range(n)]
        dist.all_gather(out, send, group=group)
        self.stats.gather_bytes += send.numel() * send.element_size()
        return out

    def broadcast_from_rank0(self, t: torch.Tensor, what: str) -> torch.Tensor:
        """Rank 0's ``t`` on every rank, on ``t``'s device."""
        if not self.distributed or self.world_size == 1:
            return t
        buf = self.to_comm(t.contiguous(), what).clone()
        dist.broadcast(buf, src=0)
        self.stats.broadcast_bytes += buf.numel() * buf.element_size()
        return self.from_comm(buf, t.device, what)

    def barrier(self) -> None:
        if self.distributed and self.world_size > 1:
            if self.backend == "nccl":
                dist.barrier(device_ids=[torch.cuda.current_device()])
            else:
                dist.barrier()


def make_mesh(time_shards: int, band_shards: int, device_type: Optional[str] = None
              ) -> Mesh:
    """The (time, band) mesh over the initialized process group; the 1x1
    mesh of one process when there is none.  Raises unless the world size
    is ``time_shards * band_shards``.  ``device_type`` is the device
    mesh's (default: ``"cuda"`` under NCCL, ``"cpu"`` under gloo)."""
    n = int(time_shards) * int(band_shards)
    if not (dist.is_available() and dist.is_initialized()):
        if n == 1:
            return Mesh(1, 1)
        raise ValueError(
            f"mesh {time_shards}x{band_shards} needs {n} processes, have 1 "
            "(no process group: call initialize_distributed first)")
    ws = dist.get_world_size()
    if ws != n:
        raise ValueError(
            f"mesh {time_shards}x{band_shards} needs {n} processes, have {ws}")
    from torch.distributed.device_mesh import init_device_mesh

    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    dm = init_device_mesh(device_type, (int(time_shards), int(band_shards)),
                          mesh_dim_names=(TIME_AXIS, BAND_AXIS))
    return Mesh(time_shards, band_shards, dm)


def initialize_distributed(backend: Optional[str] = None, device=None) -> bool:
    """Join the process group named by the variables ``torchrun`` sets
    (``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``,
    ``LOCAL_RANK``) through an ``env://`` rendezvous.  A no-op for one
    process (``WORLD_SIZE`` unset or 1): returns False; True once joined.

    ``device`` is where the caller's pipeline computes (default: CUDA when
    available).  The default backend is NCCL for CUDA and gloo for the CPU.
    Gloo with the pipeline on the card (several processes on one GPU, where
    NCCL cannot put two ranks) is used only when ``backend='gloo'`` is
    named, and is logged.  With CUDA each rank takes
    ``cuda:LOCAL_RANK % device_count``.
    """
    if int(os.environ.get("WORLD_SIZE", "1")) <= 1:
        return False
    if dist.is_initialized():
        return True
    cuda = (torch.device(device).type == "cuda" if device is not None
            else torch.cuda.is_available())
    if backend is None:
        backend = "nccl" if cuda else "gloo"
    elif backend == "gloo" and cuda:
        logger.warning(
            "backend 'gloo' with the pipeline on CUDA: halos, the resume mask "
            "and the assembly go through explicit host copies")
    if cuda:
        local = int(os.environ.get("LOCAL_RANK", os.environ.get("RANK", "0")))
        torch.cuda.set_device(local % torch.cuda.device_count())
    dist.init_process_group(backend, init_method="env://", timeout=COLLECTIVE_TIMEOUT)
    return True
