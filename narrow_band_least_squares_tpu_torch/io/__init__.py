from narrow_band_least_squares_tpu_torch.io.stream import ArrayStream
from narrow_band_least_squares_tpu_torch.io.synthetic import synthetic_plane_wave

__all__ = ["ArrayStream", "synthetic_plane_wave"]
