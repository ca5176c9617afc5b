"""PyTorch port: LTS on large arrays (P = 66 and P = 120) against the JAX
package on the CPU, the mirror of ``tests/test_large_array.py``.

The whole runs of `test_torch_lts_pipeline.py`'s helpers (`_check`: flags
exact on windows whose delays are bit-identical, estimates within 1e-4),
in a file of their own: they are the longest LTS cases, and a file runs on
one worker under ``--dist loadfile``.
"""

import numpy as np
import pytest

from narrow_band_least_squares_tpu.models.narrowband import NarrowBandPipeline as JPipe
from narrow_band_least_squares_tpu_torch.models import NarrowBandPipeline

from test_torch_lts_pipeline import BAZ, VEL, _check, _large
from test_torch_lts_pipeline import delays  # noqa: F401  (fixture)


def _element_counts(flags, pairs, nchans):
    counts = np.zeros(nchans)
    for p, (i, j) in enumerate(pairs):
        counts[i] += flags[..., p].sum()
        counts[j] += flags[..., p].sum()
    return counts


@pytest.mark.parametrize("nchans,outliers,kw", [
    (12, (3, 9), dict(alpha=0.7)),
    (16, (11,), dict(alpha=0.75, max_lts_candidates=2048, lts_candidate_chunk=512,
                     lts_funnel_k=64)),
], ids=["P66", "P120-subsampled-chunk-funnel"])
def test_large_array_matches_jax(delays, nchans, outliers, kw):
    """Mirror of ``test_large_array.py:53`` (P = 66, exhaustive) and
    ``:129`` (P = 120, subsampled, chunked, funnel): flags equal JAX's, the
    event is recovered and the outliers are the most flagged elements."""
    st, jp, tp, rij = _large(nchans, outliers, 120.0)
    want = JPipe(jp, rij, **kw).run_raw(st.data)
    pipe = NarrowBandPipeline(tp, rij, device="cpu", **kw)
    got = pipe.run_raw(st.data)
    _check(pipe, got, want, delays)
    out = {k: v.numpy() for k, v in got.items()}
    good = out["mdccm"] > 0.4
    assert good.sum() > 3
    d = np.abs((out["baz"][good] - BAZ + 180.0) % 360.0 - 180.0)
    assert np.median(d) < 4.0
    assert abs(np.median(out["vel"][good]) - VEL) < 0.03
    counts = _element_counts(out["flags"][good], pipe.pairs_np, nchans)
    assert set(np.argsort(counts)[-len(outliers):]) == set(outliers)
