"""Broadband (single-band) least-squares pipeline.

Port of ``narrow_band_least_squares_tpu/models/broadband.py``.  The
reference's broadband pass filters once over [FMIN, FMAX] and runs one
``ltsva`` sweep (reference ``example.py:108-109``); here it is the
narrow-band pipeline with one band, on the same kernels.
"""

from __future__ import annotations

import numpy as np
import torch

from narrow_band_least_squares_tpu_torch.models.narrowband import NarrowBandPipeline
from narrow_band_least_squares_tpu_torch.utils.plan import make_plan


class BroadbandPipeline(NarrowBandPipeline):
    def __init__(
        self,
        fmin: float,
        fmax: float,
        winlen_s: float,
        winover: float,
        npts: int,
        fs: float,
        rij: np.ndarray,
        filter_type: str = "cheby1",
        filter_order: int = 2,
        filter_ripple: float = 0.01,
        alpha: float = 1.0,
        apply_filter: bool = True,
        dtype=torch.float32,
        *,
        device=None,
        **kw,
    ):
        plan = make_plan([fmin, fmax], "linear", [winlen_s], winover, npts, fs)
        super().__init__(
            plan, rij,
            filter_type=filter_type, filter_order=filter_order,
            filter_ripple=filter_ripple, alpha=alpha,
            apply_filter=apply_filter, dtype=dtype, device=device, **kw,
        )
