from narrow_band_least_squares_tpu_torch.models.narrowband import (
    NarrowBandPipeline,
    NarrowBandResult,
    flags_to_stdict,
)

__all__ = ["NarrowBandPipeline", "NarrowBandResult", "flags_to_stdict"]
