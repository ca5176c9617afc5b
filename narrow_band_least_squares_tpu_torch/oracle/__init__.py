"""The NumPy/SciPy oracle: the port's copy of the JAX package's
``narrow_band_least_squares_tpu.oracle``, with the same public names.  It
imports neither torch nor the JAX package."""

from narrow_band_least_squares_tpu_torch.oracle.ltsva import (
    design_sos,
    filter_and_taper,
    ltsva_oracle,
    sliding_window_solve,
)
from narrow_band_least_squares_tpu_torch.oracle.pipeline import (
    narrow_band_least_squares_oracle,
)

__all__ = [
    "design_sos",
    "filter_and_taper",
    "ltsva_oracle",
    "sliding_window_solve",
    "narrow_band_least_squares_oracle",
]
