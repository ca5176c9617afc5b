from narrow_band_least_squares_tpu_torch.models.broadband import BroadbandPipeline
from narrow_band_least_squares_tpu_torch.models.multiarray import MultiArrayPipeline
from narrow_band_least_squares_tpu_torch.models.narrowband import (
    NarrowBandPipeline,
    NarrowBandResult,
    flags_to_stdict,
)
from narrow_band_least_squares_tpu_torch.models.streaming import (
    SegmentRecord,
    StreamingMonitor,
)

__all__ = [
    "BroadbandPipeline",
    "MultiArrayPipeline",
    "NarrowBandPipeline",
    "NarrowBandResult",
    "SegmentRecord",
    "StreamingMonitor",
    "flags_to_stdict",
]
