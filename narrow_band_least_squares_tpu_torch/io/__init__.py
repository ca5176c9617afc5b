from narrow_band_least_squares_tpu_torch.io.stream import ArrayStream, gather_waveforms
from narrow_band_least_squares_tpu_torch.io.synthetic import synthetic_plane_wave
from narrow_band_least_squares_tpu_torch.io.textio import read_txtfile, write_txtfile

__all__ = [
    "ArrayStream",
    "gather_waveforms",
    "synthetic_plane_wave",
    "write_txtfile",
    "read_txtfile",
]
from narrow_band_least_squares_tpu_torch.io.ingest import (  # noqa: F401,E402
    MSRecord,
    RingBuffer,
    StreamingIngest,
    mseed_to_stream,
    read_mseed,
    read_mseed_records,
)
