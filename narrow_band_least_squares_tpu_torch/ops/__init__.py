from narrow_band_least_squares_tpu_torch.ops import filters, windows, xcorr, solve

__all__ = ["filters", "windows", "xcorr", "solve"]
