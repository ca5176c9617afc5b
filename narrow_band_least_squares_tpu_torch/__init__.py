"""Narrow-band least-squares infrasound array processing in PyTorch and CUDA.

The port of ``narrow_band_least_squares_tpu`` (JAX, XLA and Pallas on a TPU)
to PyTorch on an NVIDIA H100.  It keeps that package's module layout and
public names, imports nothing of it, and runs on the card unless the caller
passes ``device="cpu"``; on the CPU each hand-written kernel is replaced by
its plain PyTorch version.

What is ported:

- the band/window plan, geometry and time helpers (`utils`),
- the waveform container with its ObsPy-style indexing, synthetic data and
  the reference TSV results format (`io`: ``write_txtfile`` /
  ``read_txtfile``, through a C++ codec),
- data in (`io`): miniSEED decoding and Steim1 encoding, a gap-tracking
  ring buffer and ``StreamingIngest`` (monitor-sized segments from a live
  record feed), StationXML response removal, and acquisition from FDSN
  services and Earthworm/Winston wave servers (``gather_waveforms``), on
  the port's own C++ host runtime (`native`, built by ``g++`` at first
  use),
- the frequency-domain filter bank (`ops.filters`),
- window extraction (`ops.windows`),
- DFT-as-matmul cross-correlation whose lag search is the CUDA kernel
  ``icorr_peak`` (`ops.xcorr`, `ops.kernels`, ``csrc/xcorr_peak.cu`` and
  ``csrc/xcorr_peak_tc.cu``),
- ``xcorr_method='fused'``, whose delay search per window-length bucket is
  the CUDA kernel ``fused_xcorr_bucket`` (``csrc/fused_xcorr.cu``),
- the closed-form OLS solve (`ops.solve`) and exact-enumeration LTS
  (``alpha < 1``, `ops.lts`) with its flags and stdict,
- the pipeline (`models.NarrowBandPipeline`) and the reference-parity API
  (`api`),
- `models.MultiArrayPipeline` (many arrays per step, OLS or LTS, on one
  device or data-parallel over a mesh) and `models.BroadbandPipeline` (one
  band),
- the sharded pipeline over a (time, band) mesh of processes on
  ``torch.distributed`` (`parallel.mesh`, `parallel.ShardedNarrowBandPipeline`:
  halos sent to the right neighbour, snake-dealt band shards, the final
  all-gather) and the streaming monitor on it (`models.StreamingMonitor`:
  batched dispatch, TSV/npz persistence by rank 0, resume),
- the run configuration (`config.NBLSConfig`, the JAX package's file
  format), the command line (``python -m narrow_band_least_squares_tpu_torch
  run|monitor|fetch|defaults``), the parity figures (`plotting`, host
  matplotlib, imported only by the figure code) and the run profiler
  (`utils.profiling`: phase timers, ``torch.profiler`` traces),
- the last options: sub-sample delays (``subsample_delays``, on the
  neighbour epilogue of ``icorr_peak``), ``window_method='patches'``, the
  pipeline dtypes the JAX package runs, the exact SOS recurrence
  (`ops.filters.sosfilt_scan`, the CUDA kernel ``csrc/sosfilt.cu``), and
  the NumPy/SciPy oracle (`oracle`, importing neither torch nor JAX).

With these the port does all the JAX package does, apart from its
compilation cache (``utils/compcache.py``), which eager PyTorch has no use
for.

Importing the package builds nothing: a kernel is compiled at its first
launch on the card, the host runtime at its first use.
"""

from narrow_band_least_squares_tpu_torch.config import NBLSConfig
from narrow_band_least_squares_tpu_torch.io.stream import ArrayStream

_API_NAMES = (
    "get_freqlist",
    "get_winlenlist",
    "filter_data",
    "write_txtfile",
    "read_txtfile",
    "get_rij",
    "make_float",
    "ltsva",
    "narrow_band_least_squares",
    "narrow_band_least_squares_parallel",
    "narrow_band_loop",
    "set_performance_defaults",
    "PRODUCTION_DEFAULTS",
)


_MODEL_NAMES = ("NarrowBandPipeline", "MultiArrayPipeline", "BroadbandPipeline",
                "StreamingMonitor")
_PARALLEL_NAMES = ("ShardedNarrowBandPipeline",)


def __getattr__(name):
    if name in _API_NAMES:
        from narrow_band_least_squares_tpu_torch import api
        return getattr(api, name)
    if name in _MODEL_NAMES:
        from narrow_band_least_squares_tpu_torch import models
        return getattr(models, name)
    if name in _PARALLEL_NAMES:
        from narrow_band_least_squares_tpu_torch import parallel
        return getattr(parallel, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__version__ = "0.1.0"

__all__ = ["NBLSConfig", "ArrayStream", *_API_NAMES, *_MODEL_NAMES, *_PARALLEL_NAMES]
