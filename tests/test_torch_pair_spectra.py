"""PyTorch port: the lag search's operand ``cs2`` from `pair_spectra`.

The CUDA kernel (``csrc/pair_spectra.cu``) runs only on the card, where
``chip_smoke.py`` holds it bit for bit against the eager chain.  Here, on
the CPU:

- the plain version equals the eager chain that `_cross_spectra` ran
  before the kernel (pair gathers, products, ``cat``, then ``_peak_search``'s
  zero pad), bit for bit, zero tail included;
- the kernel's arithmetic (the negation of the sine product folded in, each
  product and sum rounded on its own) has those bits too, signed zeros
  included;
- the wrapper refuses what the kernel does not take, a CPU tensor builds
  nothing and counts no launch, pair indices follow PyTorch's indexing (as
  the kernel's do), and a pipeline's pairs are checked once;
- `cross_correlate_bounds` returns the bits of the chain before the kernel,
  where ``e2``'s rows equal 2K and where they pad it.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as Fnn

from narrow_band_least_squares_tpu_torch.ops import xcorr as TXC
from narrow_band_least_squares_tpu_torch.ops.kernels import pair_spectra as PS
from narrow_band_least_squares_tpu_torch.utils.device import fp32_matmul
from narrow_band_least_squares_tpu_torch.utils.geometry import pair_indices


def _bits(t):
    return t.contiguous().view(torch.int32)


def _eager_chain(ReF, ImF, pairs, width):
    """The cross-spectra of `_cross_spectra` and the pad of `_peak_search`
    as they stood before the kernel; ReF, ImF (B, W, C, K)."""
    i, j = pairs[:, 0], pairs[:, 1]
    ReI, ImI = ReF[:, :, i, :], ImF[:, :, i, :]
    ReJ, ImJ = ReF[:, :, j, :], ImF[:, :, j, :]
    ReCS = ReJ * ReI + ImJ * ImI                     # F_j * conj(F_i)
    ImCS = ImJ * ReI - ReJ * ImI
    K = ReCS.shape[-1]
    cs2 = torch.cat([ReCS, ImCS], dim=-1).reshape(-1, 2 * K)
    return Fnn.pad(cs2, (0, width - cs2.shape[1])).contiguous()


def _kernel_arithmetic(re, s, pairs, width):
    """What each thread of the kernel computes, as separate float32 ops:
    ``re_j re_i + s_j s_i`` and ``re_j s_i - s_j re_i`` on the un-negated
    sine product, zeros past 2K."""
    i, j = pairs[:, 0], pairs[:, 1]
    ri, si, rj, sj = re[:, i], s[:, i], re[:, j], s[:, j]
    K = re.shape[-1]
    out = torch.zeros((re.shape[0] * pairs.shape[0], width))
    out[:, :K] = (rj * ri + sj * si).reshape(-1, K)
    out[:, K:2 * K] = (rj * si - sj * ri).reshape(-1, K)
    return out


def _spectra(C, K, seed, B=2, W=3):
    """re and s (B*W, C, K) with exact zeros of both signs and repeated
    values among the normals, so that ties, cancellations and signed zeros
    all occur."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, B * W, C, K)).astype(np.float32)
    x[rng.random(x.shape) < 0.05] = 0.0
    x[rng.random(x.shape) < 0.05] = -0.0
    x[0, :, 0] = x[1, :, 0]                          # re_0 == s_0
    return torch.from_numpy(x[0]), torch.from_numpy(x[1]), B, W


def _pairs(C, order):
    p = pair_indices(C)
    if order == "shuffled":
        p = p[np.random.default_rng(C).permutation(len(p))]
    return torch.from_numpy(np.ascontiguousarray(p)).long()


@pytest.mark.parametrize("order", ["pipeline", "shuffled"])
@pytest.mark.parametrize("tail", [0, 54])
@pytest.mark.parametrize("K", [37, 64])
@pytest.mark.parametrize("C", [3, 4, 8])
def test_plain_version_is_the_eager_chain_bit_for_bit(C, K, tail, order):
    re, s, B, W = _spectra(C, K, seed=C * 1000 + K + tail)
    pairs = _pairs(C, order)
    width = 2 * K + tail
    got = PS.pair_spectra(re, s, pairs, width)
    want = _eager_chain(re.reshape(B, W, C, K), (-s).reshape(B, W, C, K), pairs, width)
    assert got.shape == (B * W * pairs.shape[0], width) and got.dtype == torch.float32
    assert torch.equal(_bits(got), _bits(want))
    assert torch.equal(_bits(got[:, 2 * K:]), torch.zeros_like(_bits(got[:, 2 * K:])))


@pytest.mark.parametrize("tail", [0, 91])
@pytest.mark.parametrize("C", [3, 8])
def test_kernel_arithmetic_has_the_eager_bits(C, tail):
    """The negation folded in: (-a)(-b) is ab and (-p1) - (-p2) is p2 - p1,
    bit for bit, signed zeros included."""
    K = 45
    re, s, _, _ = _spectra(C, K, seed=7 + C + tail)
    pairs = _pairs(C, "shuffled")
    got = _kernel_arithmetic(re, s, pairs, 2 * K + tail)
    want = PS.pair_spectra_reference(re, s, pairs, 2 * K + tail)
    assert torch.equal(_bits(got), _bits(want))
    assert bool((_bits(want) == _bits(torch.tensor(-0.0))).any())   # -0.0 occurs


@pytest.mark.parametrize("bad", ["dtype", "pairs_dtype", "shape", "pairs_shape", "width",
                                 "contiguity", "devices", "device"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    re, s, _, _ = _spectra(4, 16, seed=1)
    pairs = _pairs(4, "pipeline")
    width = 32
    if bad == "dtype":
        re = re.double()
    elif bad == "pairs_dtype":
        pairs = pairs.int()
    elif bad == "shape":
        s = s[:, :, :15]
    elif bad == "pairs_shape":
        pairs = torch.cat([pairs, pairs[:, :1]], dim=1)
    elif bad == "width":
        width = 31
    elif bad == "contiguity":
        re = re.transpose(0, 1).contiguous().transpose(0, 1)
    elif bad == "devices":
        pairs = pairs.to("meta")
    else:
        re, s, pairs = (t.to("meta") for t in (re, s, pairs))
    with pytest.raises((TypeError, ValueError)):
        PS.pair_spectra(re, s, pairs, width)


def test_cpu_tensors_take_the_plain_version_and_count_nothing():
    before = PS.launches
    re, s, _, _ = _spectra(8, 33, seed=3)
    pairs = _pairs(8, "pipeline")
    got = PS.pair_spectra(re, s, pairs, 128)
    assert torch.equal(got, PS.pair_spectra_reference(re, s, pairs, 128))
    assert PS.launches == before
    assert PS._bound is None   # nothing was built or loaded


@pytest.mark.parametrize("bad", ["negative", "too_large", "shape"])
def test_check_pairs_refuses_indices_the_kernel_cannot_read(bad):
    pairs = pair_indices(5)
    PS.check_pairs(pairs, 5)
    if bad == "negative":
        pairs = pairs - 1
    elif bad == "too_large":
        pairs = pairs.copy()
        pairs[-1, 1] = 5
    else:
        pairs = pairs[:, :1]
    with pytest.raises(ValueError):
        PS.check_pairs(pairs, 5)


@pytest.mark.parametrize("index", [-1, -5, 5, -6])
def test_indices_follow_pytorch_indexing(index):
    """The contract the kernel keeps on the card: an index in [-C, 0)
    counts from the end, one outside [-C, C) is an error."""
    re, s, _, _ = _spectra(5, 16, seed=4)
    pairs = _pairs(5, "pipeline")
    bad = pairs.clone()
    bad[3, 0] = index
    if -5 <= index < 5:
        pairs[3, 0] = index % 5
        assert torch.equal(_bits(PS.pair_spectra(re, s, bad, 40)),
                           _bits(PS.pair_spectra(re, s, pairs, 40)))
    else:
        with pytest.raises(IndexError):
            PS.pair_spectra(re, s, bad, 40)


def _batch(C, Lmax=100, seed=9):
    rng = np.random.default_rng(seed)
    lengths = np.array([100, 60])
    win = rng.standard_normal((2, 4, C, Lmax)).astype(np.float32)
    for b, L in enumerate(lengths):
        win[b, :, :, L:] = 0.0
    return torch.from_numpy(win), lengths


def _before(win, pairs, lo, hi, tables, fs, subsample):
    """`cross_correlate_bounds` as it stood before the kernel."""
    e2 = TXC.stack_inverse_table(tables["Ec"], tables["Es"])
    B, W, C, Lmax = win.shape
    energy = torch.sum(win * win, dim=-1)
    flat = win.reshape(B * W * C, Lmax).to(tables["Cf"].dtype)
    with fp32_matmul():
        ReF = torch.matmul(flat, tables["Cf"]).reshape(B, W, C, -1)
        ImF = (-torch.matmul(flat, tables["Sf"])).reshape(B, W, C, -1)
    cs2 = _eager_chain(ReF, ImF, pairs, e2.shape[0])
    return TXC._peak_search(win, pairs, energy, cs2, e2, lo, hi, tables["lag_min"], fs,
                            subsample=subsample)


@pytest.mark.parametrize("subsample", [False, True])
@pytest.mark.parametrize("rows", ["padded", "exact"])
def test_cross_correlate_bounds_keeps_its_bits(rows, subsample):
    """``e2``'s rows pad 2K (202 bins to 256) or equal it (64 bins, 128)."""
    C = 5
    win, lengths = _batch(C)
    tab = TXC.precompute_dft_tables(100, np.float32)
    if rows == "exact":
        tab = TXC.slice_tables_bins(tab, 0, 63)
    tables = {k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v)
              for k, v in tab.items()}
    K = tables["Cf"].shape[1]
    assert (TXC._round_up_128(2 * K) == 2 * K) == (rows == "exact")
    half = 99
    lo = torch.from_numpy((half - (lengths - 1)).astype(np.int32))
    hi = torch.from_numpy((half + (lengths - 1)).astype(np.int32))
    pairs = _pairs(C, "pipeline")
    got = TXC.cross_correlate_bounds(win, pairs, lo, hi, tables, 10.0, subsample=subsample)
    want = _before(win, pairs, lo, hi, tables, 10.0, subsample)
    for g, w in zip(got, want):
        assert torch.equal(_bits(g), _bits(w))
