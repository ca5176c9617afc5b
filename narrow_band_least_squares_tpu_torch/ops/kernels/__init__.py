from narrow_band_least_squares_tpu_torch.ops.kernels.fused_xcorr import (
    fused_xcorr_bucket,
    fused_xcorr_bucket_reference,
    precompute_fused_tables,
)
from narrow_band_least_squares_tpu_torch.ops.kernels.xcorr_peak import (
    icorr_peak,
    icorr_peak_reference,
)

__all__ = [
    "fused_xcorr_bucket",
    "fused_xcorr_bucket_reference",
    "precompute_fused_tables",
    "icorr_peak",
    "icorr_peak_reference",
]
