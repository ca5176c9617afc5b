from narrow_band_least_squares_tpu_torch.ops.kernels.xcorr_peak import (
    icorr_peak,
    icorr_peak_reference,
)

__all__ = ["icorr_peak", "icorr_peak_reference"]
