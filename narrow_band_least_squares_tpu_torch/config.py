"""Run configuration.

The port's copy of ``narrow_band_least_squares_tpu/config.py``: the
reference driver's ~20 "User Input" constants (reference
``example.py:38-72``) as a frozen dataclass with the same names, defaults,
field order and validation, and a JSON/YAML front-end.  A config file means
the same thing to both packages: one written by either loads in the other
with equal ``to_dict()`` and ``perf_overrides()``.

The fields below "device compute" are the JAX package's own extensions.  The
port keeps them all so that files round-trip; what the port does with each:

- ``dtype``, ``filter_method`` and ``mesh_shape`` are not read by the
  command line of either package (``perf_overrides`` leaves them out);
- ``xcorr_chunk_mb`` and ``xcorr_lag_tile`` reach the pipeline, which
  accepts them and changes nothing (they bound a correlation tensor that the
  port's lag-search kernel never forms);
- every other option reaches the pipeline and runs as in the JAX package:
  ``xcorr_method`` 'mxu', 'pallas', 'fused' and 'fft', ``window_method``
  'strided', 'gather' and 'patches' (which turns bucketing off).
  ``subsample_delays`` is no field of either package's file; the port's
  command line takes it as ``--subsample-delays``.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass
from typing import Optional, Tuple

FREQ_BAND_TYPES = (
    "linear",
    "log",
    "octave",
    "2_octave_over",
    "onethird_octave",
    "octave_linear",
)
FILTER_TYPES = ("butter", "cheby1")
WINDOW_LENGTH_TYPES = ("constant", "adaptive")


@dataclass(frozen=True)
class NBLSConfig:
    """All knobs of a narrow-band least-squares run.

    Field names match the reference driver's "User Input" block
    (reference ``example.py:38-72``) so configs translate one-to-one.
    """

    # --- Data selection (used by io.gather_waveforms; reference example.py:40-47)
    SOURCE: str = "IRIS"
    NETWORK: str = "IM"
    STATION: str = "I53H?"
    LOCATION: str = "*"
    CHANNEL: str = "BDF"
    START: Optional[str] = "2018-12-19T01:45:00"  # ISO-8601 UTC
    END: Optional[str] = "2018-12-19T02:05:00"

    # --- Filtering (reference example.py:50-56)
    FMIN: float = 0.1
    FMAX: float = 5.0
    NBANDS: int = 8
    FREQ_BAND_TYPE: str = "log"
    FILTER_TYPE: str = "cheby1"
    FILTER_ORDER: int = 2
    FILTER_RIPPLE: float = 0.01

    # --- Window plan (reference example.py:59-63)
    WINOVER: float = 0.5
    WINDOW_LENGTH_TYPE: str = "adaptive"
    WINLEN: int = 50
    WINLEN_1: int = 60
    WINLEN_X: int = 30

    # --- Estimator (reference example.py:66-68)
    ALPHA: float = 1.0  # 1.0 = ordinary LS; [0.5, 1) = robust LTS
    MDCCM_THRESH: float = 0.6
    PLOT_ARRAY_COORDINATES: bool = False

    # --- Figure output (reference example.py:71-72)
    file_type: str = ".png"
    dpi_num: int = 300

    # --- device compute (no reference equivalent)
    dtype: str = "float32"          # device compute dtype
    filter_method: str = "fft"      # 'fft' (frequency-domain exact-IIR) | 'scan'
    lts_c_steps: int = 4            # concentration steps per elemental candidate
    mesh_shape: Tuple[int, int] = (1, 1)   # (time_shards, band_shards)

    # --- pipeline options (the command line applies these to every
    #     pipeline via api.set_performance_defaults; see
    #     models.NarrowBandPipeline)
    xcorr_method: str = "mxu"       # 'mxu' | 'pallas' | 'fused' | 'fft'
    window_method: str = "strided"  # 'strided' | 'gather' | 'patches'
    max_lag_s: Optional[float] = None   # physical lag cap [s] (None = full)
    matmul_precision: str = "high"  # 'highest' (fp32) | 'high' (3xTF32) | 'default' (1xTF32)
    lts_funnel_k: object = 0        # FAST-LTS funnel top-K; 0 = exact
    #   all-candidate, 'auto' = max(16, ceil(Q/24))
    xcorr_chunk_mb: float = 16.0    # accepted, changes nothing in the port
    xcorr_lag_tile: int = 512       # accepted, changes nothing in the port
    band_limit_db: object = 0.0     # >0 dB or "auto": passband-bin xcorr

    def __post_init__(self):
        if self.FREQ_BAND_TYPE not in FREQ_BAND_TYPES:
            raise ValueError(
                f"FREQ_BAND_TYPE must be one of {FREQ_BAND_TYPES}, "
                f"got {self.FREQ_BAND_TYPE!r}"
            )
        if self.FILTER_TYPE not in FILTER_TYPES:
            raise ValueError(
                f"FILTER_TYPE must be one of {FILTER_TYPES}, got {self.FILTER_TYPE!r}"
            )
        if self.WINDOW_LENGTH_TYPE not in WINDOW_LENGTH_TYPES:
            raise ValueError(
                f"WINDOW_LENGTH_TYPE must be one of {WINDOW_LENGTH_TYPES}, "
                f"got {self.WINDOW_LENGTH_TYPE!r}"
            )
        if not (0.0 <= self.WINOVER < 1.0):
            raise ValueError(f"WINOVER must be in [0, 1), got {self.WINOVER}")
        if not (0.5 <= self.ALPHA <= 1.0):
            raise ValueError(f"ALPHA must be in [0.5, 1.0], got {self.ALPHA}")
        if not (0.0 <= self.MDCCM_THRESH <= 1.0):
            raise ValueError(
                f"MDCCM_THRESH must be in [0, 1], got {self.MDCCM_THRESH}"
            )
        if self.FMIN <= 0 or self.FMAX <= self.FMIN:
            raise ValueError(
                f"Need 0 < FMIN < FMAX, got FMIN={self.FMIN} FMAX={self.FMAX}"
            )

    def perf_overrides(self) -> dict:
        """Pipeline kwargs for `api.set_performance_defaults` (only values
        that differ from the pipeline defaults, so configs written by older
        versions behave identically)."""
        out = {}
        for key, default in (
            ("xcorr_method", "mxu"),
            ("window_method", "strided"),
            ("max_lag_s", None),
            ("matmul_precision", "high"),
            ("lts_funnel_k", 0),
            ("xcorr_chunk_mb", 16.0),
            ("xcorr_lag_tile", 512),
            ("band_limit_db", 0.0),
        ):
            v = getattr(self, key)
            if v != default:
                out[key] = v
        if self.lts_c_steps != 4:
            out["c_steps"] = self.lts_c_steps
        return out

    # ------------------------------------------------------------------ I/O
    def replace(self, **kw) -> "NBLSConfig":
        return dataclasses.replace(self, **kw)

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["mesh_shape"] = list(self.mesh_shape)
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "NBLSConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        kw = {k: v for k, v in d.items() if k in known}
        if "mesh_shape" in kw:
            kw["mesh_shape"] = tuple(kw["mesh_shape"])
        return cls(**kw)

    def to_json(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=2)

    @classmethod
    def from_json(cls, path: str) -> "NBLSConfig":
        with open(path) as f:
            return cls.from_dict(json.load(f))

    @classmethod
    def from_yaml(cls, path: str) -> "NBLSConfig":
        try:
            import yaml  # type: ignore
        except ImportError as e:
            raise ImportError("pyyaml is required for from_yaml") from e
        with open(path) as f:
            return cls.from_dict(yaml.safe_load(f))
