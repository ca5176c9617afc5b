from narrow_band_least_squares_tpu_torch.parallel.mesh import (
    BAND_AXIS,
    TIME_AXIS,
    Mesh,
    auto_mesh_shape,
    initialize_distributed,
    make_mesh,
)
from narrow_band_least_squares_tpu_torch.parallel.sharded import ShardedNarrowBandPipeline

__all__ = [
    "BAND_AXIS",
    "TIME_AXIS",
    "Mesh",
    "ShardedNarrowBandPipeline",
    "auto_mesh_shape",
    "initialize_distributed",
    "make_mesh",
]
