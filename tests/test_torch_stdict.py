"""PyTorch port: `models.narrowband.flags_to_stdict`, the host's LTS flag
dictionary, against a plain loop over every valid window and flagged pair.

The dictionary must be the loop's exactly: the same keys in the same
insertion order (band by band, window by window, ``"size"`` last), with
``band_prefix=False`` a repeated window time keeping its first place and
the last band's value, and every value an ``int64`` array of the same
1-based elements in ascending pair order.  Flags in the padded rows
(``w >= num_compute_list[b]``) are ignored.
"""

import itertools

import numpy as np
import pytest

from narrow_band_least_squares_tpu_torch.models.narrowband import flags_to_stdict
from narrow_band_least_squares_tpu_torch.utils.timeutils import stdict_timestamp_key


def loop_stdict(flags, t_array, num_compute_list, pairs, nchans, band_prefix=True):
    """The per-window, per-pair loop the dictionary is held to."""
    out = {}
    B = flags.shape[0]
    for b in range(B):
        for w in range(int(num_compute_list[b])):
            flagged = np.where(flags[b, w])[0]
            elements = []
            for p in flagged:
                i, j = pairs[p]
                elements.extend([int(i) + 1, int(j) + 1])
            key = stdict_timestamp_key(t_array[b, w])
            if band_prefix:
                key = str(b + 1).zfill(2) + "_" + key
            out[key] = np.asarray(elements, dtype=np.int64)
    out["size"] = int(nchans)
    return out


def flag_case(nchans, B, seed=20231):
    """Flags, window times and window counts from a fixed seed: random
    flags, one window a band with none and one with every pair flagged,
    the padded rows all flagged, and every band on one time grid so that
    window times repeat across bands."""
    rng = np.random.default_rng(seed + 1000 * nchans + B)
    pairs = np.array(list(itertools.combinations(range(nchans), 2)))
    P, Wmax = len(pairs), 23
    num_compute = rng.integers(Wmax // 2, Wmax + 1, size=B)
    num_compute[0] = Wmax
    num_compute[-1] = min(num_compute[-1], Wmax - 4)
    flags = rng.random((B, Wmax, P)) < 0.3
    for b, n in enumerate(num_compute):
        flags[b, 1] = False
        flags[b, 2] = True
        flags[b, n:] = True
    t_array = np.zeros((B, Wmax + 5))
    t_array[:, :Wmax] = 19345.0 + np.arange(Wmax) * (15.0 / 86400.0)
    return flags, t_array, [int(n) for n in num_compute], pairs


@pytest.mark.parametrize("band_prefix", [True, False])
@pytest.mark.parametrize("B", [1, 8])
@pytest.mark.parametrize("nchans", [3, 8, 16])   # P = 3, 28, 120
def test_stdict_equals_the_per_window_loop(nchans, B, band_prefix):
    flags, t_array, num_compute, pairs = flag_case(nchans, B)
    args = (flags, t_array, num_compute, pairs, nchans)

    want = loop_stdict(*args, band_prefix=band_prefix)
    got = flags_to_stdict(*args, band_prefix=band_prefix)

    assert list(got) == list(want)
    assert list(got)[-1] == "size"
    assert type(got["size"]) is int and got["size"] == nchans
    for key in want:
        if key == "size":
            continue
        assert got[key].dtype == np.int64, key
        assert np.array_equal(got[key], want[key]), key
    assert any(len(v) == 0 for k, v in got.items() if k != "size")
    assert any(len(v) == 2 * len(pairs) for k, v in got.items() if k != "size")
    if band_prefix or B == 1:
        assert len(got) == sum(num_compute) + 1
    else:   # the bands share their window times, so later bands overwrite
        assert len(got) == max(num_compute) + 1
