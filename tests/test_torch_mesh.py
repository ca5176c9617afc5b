"""PyTorch port: `parallel.mesh` (`auto_mesh_shape`, `make_mesh`,
`initialize_distributed`, the 1x1 mesh of one process) against the JAX
package's ``parallel/mesh.py``.

``auto_mesh_shape`` is the same arithmetic (``tests/test_sharding.py:55-63``
fixes its answers); ``make_mesh`` needs a process group of exactly
``nt * nb`` ranks, except the 1x1 mesh, which needs none.  The rank layout
and the groups are checked over a gloo group of one process here; several
processes are ``tests/test_torch_multihost.py``'s.
"""

import os

import pytest
import torch
import torch.distributed as dist

from narrow_band_least_squares_tpu.parallel import auto_mesh_shape as jauto
from narrow_band_least_squares_tpu_torch.parallel import (
    BAND_AXIS,
    TIME_AXIS,
    Mesh,
    auto_mesh_shape,
    initialize_distributed,
    make_mesh,
)
from narrow_band_least_squares_tpu_torch.parallel.smoke import free_port

GRID = [(n, b) for n in (1, 2, 3, 4, 6, 8, 16) for b in (None, 1, 3, 4, 8, 12, 24, 48, 50)]


@pytest.mark.parametrize("n_devices", sorted({n for n, _ in GRID}))
def test_auto_mesh_shape_matches_jax(n_devices):
    for n, nbands in GRID:
        if n == n_devices:
            assert auto_mesh_shape(n, nbands) == jauto(n, nbands), (n, nbands)
            assert auto_mesh_shape(n, nbands, 3) == jauto(n, nbands, 3), (n, nbands)


def test_auto_mesh_shape_fixed_answers():
    assert auto_mesh_shape(8, nbands=48) == (1, 8)
    assert auto_mesh_shape(8, nbands=50) == (4, 2)
    assert auto_mesh_shape(8, nbands=4) == (8, 1)
    assert auto_mesh_shape(8, nbands=3) == (8, 1)
    assert auto_mesh_shape(4, nbands=8) == (4, 1)
    assert auto_mesh_shape(4, nbands=24) == (1, 4)
    assert auto_mesh_shape(4, nbands=50) == (2, 2)


def test_one_by_one_mesh_needs_no_process_group():
    assert not dist.is_initialized()
    mesh = make_mesh(1, 1)
    assert isinstance(mesh, Mesh) and not mesh.distributed
    assert (mesh.nt, mesh.nb, mesh.rank, mesh.t, mesh.b) == (1, 1, 0, 0, 0)
    assert mesh.shape == {TIME_AXIS: 1, BAND_AXIS: 1} and mesh.world_size == 1
    tail = torch.arange(6.0).reshape(2, 3)
    assert torch.equal(mesh.send_right(tail), torch.zeros(2, 3))   # the cold start
    parts = mesh.all_gather(tail, "x")
    assert len(parts) == 1 and torch.equal(parts[0], tail)
    assert torch.equal(mesh.broadcast_from_rank0(tail, "x"), tail)
    mesh.barrier()
    assert mesh.stats.host_copy_bytes == 0 and mesh.stats.gather_bytes == 0


@pytest.mark.parametrize("shape", [(2, 1), (1, 2), (2, 2)])
def test_make_mesh_without_a_process_group_raises(shape):
    with pytest.raises(ValueError, match="needs"):
        make_mesh(*shape)
    with pytest.raises(ValueError, match="device mesh"):
        Mesh(*shape)


def test_initialize_distributed_is_a_noop_for_one_process(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert initialize_distributed() is False
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert initialize_distributed(device="cpu") is False
    assert not dist.is_initialized()


@pytest.fixture
def one_rank_group(monkeypatch):
    """A gloo process group of one rank, joined through initialize_distributed's
    env:// rendezvous (WORLD_SIZE=1 is a no-op there, so join directly)."""
    monkeypatch.setenv("MASTER_ADDR", "localhost")
    monkeypatch.setenv("MASTER_PORT", str(free_port()))
    dist.init_process_group("gloo", init_method="env://", rank=0, world_size=1)
    yield
    dist.destroy_process_group()


def test_make_mesh_on_a_group(one_rank_group):
    with pytest.raises(ValueError, match="needs 2 processes, have 1"):
        make_mesh(2, 1)
    with pytest.raises(ValueError, match="needs 4 processes, have 1"):
        make_mesh(2, 2)
    mesh = make_mesh(1, 1)
    assert mesh.distributed and mesh.backend == "gloo"
    assert (mesh.rank, mesh.t, mesh.b) == (0, 0, 0)
    assert dist.get_process_group_ranks(mesh.time_group) == [0]
    assert dist.get_process_group_ranks(mesh.band_group) == [0]
    x = torch.arange(4, dtype=torch.float32)
    (got,) = mesh.all_gather(x, "x")
    assert torch.equal(got, x) and mesh.stats.gather_bytes == 16
    assert torch.equal(mesh.send_right(x), torch.zeros(4))


def test_nccl_refuses_a_cpu_tensor():
    """Under NCCL a CPU tensor in a collective raises: nothing is copied to
    the card quietly (checked on the staging step, no NCCL needed)."""
    mesh = Mesh(1, 1)
    mesh.backend = "nccl"
    with pytest.raises(RuntimeError, match="NCCL takes CUDA tensors"):
        mesh.to_comm(torch.zeros(3), "the halo")
    mesh.backend = "gloo"
    x = torch.zeros(3)
    assert mesh.to_comm(x, "the halo") is x and mesh.stats.host_copy_bytes == 0


def test_gloo_on_cuda_is_named_and_logged(monkeypatch, caplog):
    """initialize_distributed picks NCCL for CUDA and gloo for the CPU;
    gloo with CUDA only when named, and then it says so."""
    calls = []
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    monkeypatch.setattr(dist, "init_process_group", lambda b, **kw: calls.append(b))
    monkeypatch.setattr(torch.cuda, "set_device", lambda d: None)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert initialize_distributed(device="cpu") and calls[-1] == "gloo"
    assert initialize_distributed(device="cuda") and calls[-1] == "nccl"
    with caplog.at_level("WARNING", logger="nbls_torch.parallel"):
        assert initialize_distributed("gloo", device="cuda") and calls[-1] == "gloo"
    assert "host copies" in caplog.text


def test_pipeline_on_a_one_rank_group_equals_no_group(one_rank_group):
    """`run` through a 1x1 device mesh on a process group (the halo skipped,
    the all-gather of one rank) equals the mesh-less pipeline bit for bit,
    as the card's NCCL case is held."""
    import numpy as np

    from narrow_band_least_squares_tpu_torch.parallel import ShardedNarrowBandPipeline
    from narrow_band_least_squares_tpu_torch.parallel.smoke import inputs

    st, plan, rij, _ = inputs("small", hours=800 / 3600)
    meshed = ShardedNarrowBandPipeline(plan, rij, make_mesh(1, 1), device="cpu")
    alone = ShardedNarrowBandPipeline(plan, rij, device="cpu")
    segs = alone.segment_stream(st.data)
    got, want = meshed.run(segs), alone.run(segs)
    assert meshed.mesh.distributed and meshed.mesh.stats.gather_bytes > 0
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
