from narrow_band_least_squares_tpu_torch.utils.geometry import (
    vincenty_inverse,
    get_rij,
    coarray,
)
from narrow_band_least_squares_tpu_torch.utils.plan import (
    get_freqlist,
    get_winlenlist,
    band_edges,
    WindowPlan,
    NarrowBandPlan,
    make_plan,
)
from narrow_band_least_squares_tpu_torch.utils.timeutils import (
    parse_utc,
    epoch_to_datenum,
    datenum_to_epoch,
)

__all__ = [
    "vincenty_inverse",
    "get_rij",
    "coarray",
    "get_freqlist",
    "get_winlenlist",
    "band_edges",
    "WindowPlan",
    "NarrowBandPlan",
    "make_plan",
    "parse_utc",
    "epoch_to_datenum",
    "datenum_to_epoch",
]
