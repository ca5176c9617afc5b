"""PyTorch port: `run`'s frequency responses kept per pipeline
(`NarrowBandPipeline._freq_response`), keyed by the exact bytes, dtype and
shape of the caller's frequency list.

Every call's ``w_array``/``h_array`` must be bit for bit a fresh
`sosfreqz_bank` of the pipeline's filters, hit or miss, and fresh arrays:
changing one call's result changes no other.
"""

from fractions import Fraction

import numpy as np
import pytest

from narrow_band_least_squares_tpu_torch import api
from narrow_band_least_squares_tpu_torch.io import synthetic_plane_wave
from narrow_band_least_squares_tpu_torch.models import narrowband as NB
from narrow_band_least_squares_tpu_torch.ops import filters as F


@pytest.fixture(scope="module")
def small():
    st = synthetic_plane_wave(nchans=4, duration_s=120, fs=10.0, baz_deg=230.0,
                              trace_vel_kms=0.34, f0=0.6, bandwidth=0.8, snr=8, seed=7)
    freqlist, nbands, _ = api.get_freqlist(0.3, 1.5, "log", 3)
    winlens = api.get_winlenlist("adaptive", nbands, 0, 40, 20)
    plan = api.make_plan(freqlist, "log", winlens, 0.5, st.npts, st.fs)
    rij = api.get_rij(list(st.latitudes), list(st.longitudes), st.nchans)
    return st, plan, rij


def counts():
    return NB.freqz_misses, NB.freqz_hits


def freqs(n=40, top=1.0):
    return np.logspace(-2, np.log10(top * 5.0), n)


def same_bits(got, pipe, fr):
    """``got`` (w, h) is bit for bit a fresh ``sosfreqz_bank`` at ``fr``."""
    want = F.sosfreqz_bank(pipe.sos_list, np.asarray(fr), pipe.plan.fs)
    for g, w in zip(got, want, strict=True):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert g.tobytes() == w.tobytes()


def repeated_calls_are_sosfreqz_bits(pipe, st):
    fr = freqs()
    for _ in range(3):
        r = pipe.run(st, freq_resp_list=fr)
        same_bits((r.w_array, r.h_array), pipe, fr)


def one_miss_then_hits(pipe, st):
    fr = freqs()
    for k in range(4):
        pipe.run(st, freq_resp_list=fr)
        assert counts() == (1, k)


def a_changed_result_changes_no_other_call(pipe, st):
    fr = freqs()
    a = pipe.run(st, freq_resp_list=fr)
    b = pipe.run(st, freq_resp_list=fr)
    assert not np.shares_memory(a.h_array, b.h_array)
    assert not np.shares_memory(a.w_array, b.w_array)
    a.h_array[:] = 0
    b.w_array[:] = 0
    c = pipe.run(st, freq_resp_list=fr)
    assert counts() == (1, 2)
    same_bits((c.w_array, c.h_array), pipe, fr)


def a_list_changed_in_place_misses(pipe, st):
    fr = freqs()
    pipe.run(st, freq_resp_list=fr)
    fr[5] *= 1.5
    r = pipe.run(st, freq_resp_list=fr)
    assert counts() == (2, 0)
    same_bits((r.w_array, r.h_array), pipe, fr)


def the_same_values_as_float32_miss(pipe, st):
    fr = freqs().astype(np.float32).astype(np.float64)
    pipe.run(st, freq_resp_list=fr)
    r = pipe.run(st, freq_resp_list=fr.astype(np.float32))
    assert counts() == (2, 0)
    same_bits((r.w_array, r.h_array), pipe, fr.astype(np.float32))


def a_list_of_a_new_length_misses(pipe, st):
    pipe.run(st, freq_resp_list=freqs(40))
    r = pipe.run(st, freq_resp_list=freqs(41))
    assert counts() == (2, 0)
    assert r.h_array.shape == (pipe.plan.nbands, 41)
    same_bits((r.w_array, r.h_array), pipe, freqs(41))


def the_cache_is_bounded(pipe, st):
    lists = [freqs(top=1.0 - 0.1 * k) for k in range(5)]
    for fr in lists:
        pipe.run(st, freq_resp_list=fr)
    assert counts() == (5, 0)
    pipe.run(st, freq_resp_list=lists[-1])        # still kept
    assert counts() == (5, 1)
    r = pipe.run(st, freq_resp_list=lists[0])     # the oldest, dropped
    assert counts() == (6, 1)
    same_bits((r.w_array, r.h_array), pipe, lists[0])


def an_object_array_is_never_kept(pipe, st):
    # its bytes are the addresses of its items, not their values
    fr = np.asarray([Fraction(k, 8) for k in range(1, 30)])
    for k in range(2):
        r = pipe.run(st, freq_resp_list=fr)
        assert counts() == (k + 1, 0)
    same_bits((r.w_array, r.h_array), pipe, fr)


def no_list_no_response(pipe, st):
    r = pipe.run(st)
    assert r.w_array is None and r.h_array is None
    r = pipe.run(st, freq_resp_list=None)
    assert r.w_array is None and r.h_array is None
    assert counts() == (0, 0)


CASES = [repeated_calls_are_sosfreqz_bits, one_miss_then_hits,
         a_changed_result_changes_no_other_call, a_list_changed_in_place_misses,
         the_same_values_as_float32_miss, a_list_of_a_new_length_misses,
         the_cache_is_bounded, an_object_array_is_never_kept, no_list_no_response]


@pytest.mark.parametrize("case", CASES, ids=[c.__name__ for c in CASES])
def test_freq_responses_are_kept_per_pipeline(small, monkeypatch, case):
    st, plan, rij = small
    monkeypatch.setattr(NB, "freqz_hits", 0)
    monkeypatch.setattr(NB, "freqz_misses", 0)
    case(NB.NarrowBandPipeline(plan, rij, device="cpu"), st)
