from narrow_band_least_squares_tpu_torch.io.stream import ArrayStream
from narrow_band_least_squares_tpu_torch.io.synthetic import synthetic_plane_wave
from narrow_band_least_squares_tpu_torch.io.textio import read_txtfile, write_txtfile

__all__ = ["ArrayStream", "synthetic_plane_wave", "read_txtfile", "write_txtfile"]
