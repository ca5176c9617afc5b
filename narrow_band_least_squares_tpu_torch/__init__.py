"""Narrow-band least-squares infrasound array processing in PyTorch and CUDA.

The port of ``narrow_band_least_squares_tpu`` (JAX, XLA and Pallas on a TPU)
to PyTorch on an NVIDIA H100.  It keeps that package's module layout and
public names, imports nothing of it, and runs on the card unless the caller
passes ``device="cpu"``; on the CPU each hand-written kernel is replaced by
its plain PyTorch version.

What is ported so far is the OLS narrow-band main path:

- the band/window plan, geometry and time helpers (`utils`),
- the waveform container and synthetic data (`io`),
- the frequency-domain filter bank (`ops.filters`),
- window extraction (`ops.windows`),
- DFT-as-matmul cross-correlation whose lag search is the CUDA kernel
  ``icorr_peak`` (`ops.xcorr`, `ops.kernels`, ``csrc/xcorr_peak.cu``),
- the closed-form OLS slowness solve (`ops.solve`),
- the pipeline (`models.NarrowBandPipeline`) and the reference-parity API
  (`api`),
- ``xcorr_method='fused'``, whose delay search per window-length bucket is
  the CUDA kernel ``fused_xcorr_bucket`` (``csrc/fused_xcorr.cu``),
- `models.MultiArrayPipeline` (many arrays per step, OLS, one device) and
  `models.BroadbandPipeline` (one band).

Importing the package builds no kernel: a kernel is compiled at its first
launch on the card.
"""

from narrow_band_least_squares_tpu_torch.io.stream import ArrayStream

_API_NAMES = (
    "get_freqlist",
    "get_winlenlist",
    "filter_data",
    "get_rij",
    "make_float",
    "ltsva",
    "narrow_band_least_squares",
    "narrow_band_least_squares_parallel",
    "narrow_band_loop",
    "set_performance_defaults",
    "PRODUCTION_DEFAULTS",
)


_MODEL_NAMES = ("NarrowBandPipeline", "MultiArrayPipeline", "BroadbandPipeline")


def __getattr__(name):
    if name in _API_NAMES:
        from narrow_band_least_squares_tpu_torch import api
        return getattr(api, name)
    if name in _MODEL_NAMES:
        from narrow_band_least_squares_tpu_torch import models
        return getattr(models, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__version__ = "0.1.0"

__all__ = ["ArrayStream", *_API_NAMES, *_MODEL_NAMES]
