"""PyTorch port: the matmul-precision contract of ``fused_xcorr_bucket``.

On the card ``matmul_precision`` picks the route of both products of the
fused kernel: 'highest' is IEEE fp32 on the CUDA cores, 'high' 3xTF32 and
'default' one tf32 pass on the tensor cores.  The kernels run only on the
card, where ``chip_smoke.py`` holds each route against
``fused_xcorr_bucket_reference(..., precision=)``.  Here, on the CPU:

- the emulated 'high' is within 1e-5 of fp32 (rho relative to the largest
  peak), with ``idx`` equal except at near-ties;
- the emulated 'default' is the documented rounding, step by step, and two
  orders of its sums stay within the tolerance the card holds the
  'default' kernel to;
- the operands that `prepare` builds for each route: the split tables of
  the tensor-core route have the kernel's shapes and zero padding, and hi
  + lo reconstructs each table; the padded ``e2`` of the fp32
  ``icorr_peak`` route gives the unpadded result;
- the card route's chunk plan keeps every scratch buffer within its budget
  and accepts the shapes the one-launch design accepted, and a shape past
  32-bit offsets raises;
- on CPU tensors every precision computes IEEE fp32, so the port's fused
  pipeline equals the JAX package's fused run at 'highest' at every port
  precision within 1e-4;
- an unknown precision raises.
"""

import numpy as np
import pytest
import torch

from narrow_band_least_squares_tpu.models.narrowband import NarrowBandPipeline as JPipe
from narrow_band_least_squares_tpu.utils.geometry import get_rij
from narrow_band_least_squares_tpu_torch.models.narrowband import NarrowBandPipeline as TPipe
from narrow_band_least_squares_tpu_torch.ops.kernels import fused_xcorr as FX
from narrow_band_least_squares_tpu_torch.ops.kernels import xcorr_peak as XP

from test_torch_fused import PAIRS, _bucket
from test_torch_pipeline import OUTS, _close, _plans

KERNEL_RTOL = 1e-5
# chip_smoke.py's FUSED_DEFAULT_ATOL: the card's 'default' kernel against
# its emulation, absolute in rho
FUSED_DEFAULT_ATOL = 1.2e-4
PRECISIONS = ("highest", "high", "default")


def _ragged_args():
    ins, W = _bucket(None)
    tab = FX.precompute_fused_tables(48, PAIRS, 4)
    args = [torch.from_numpy(ins[k]) for k in ("y", "hop", "maxstart", "lo", "hi", "len_mask")]
    args += [torch.from_numpy(tab[k]) for k in ("Cf", "Sf", "Ec", "Es")]
    return args + [torch.from_numpy(PAIRS), W]


@pytest.fixture(scope="module")
def stream_args(small_stream):
    """The fused launches of the port's CPU pipeline on ``small_stream`` (a
    coherent plane wave, 4 adaptive bands): real buckets."""
    st = small_stream
    _, tp = _plans(st, 4, "adaptive")
    pipe = TPipe(tp, get_rij(st.latitudes, st.longitudes, st.nchans),
                 xcorr_method="fused", device="cpu")
    real, seen = FX.fused_xcorr_bucket, []

    def rec(*args, **kw):
        seen.append(list(args))
        return real(*args, **kw)

    FX.fused_xcorr_bucket = rec
    try:
        pipe.run_raw(st.data)
    finally:
        FX.fused_xcorr_bucket = real
    return seen


def _cases(stream_args):
    return [("ragged", _ragged_args())] + [
        (f"bucket{i}", a) for i, a in enumerate(stream_args)]


def test_reference_high_is_fp32_within_1e5(stream_args):
    """'high' (emulated 3xTF32 in both DFTs) against fp32: rho within
    KERNEL_RTOL of the largest |rho|; idx equal except at near-ties, where
    the float64 correlation at the 'high' lag lies within KERNEL_RTOL (rho
    units) of the float64 maximum."""
    for name, args in _cases(stream_args):
        rh, ih = FX.fused_xcorr_bucket_reference(*args, precision="high")
        rf, i_f = FX.fused_xcorr_bucket_reference(*args, precision="highest")
        scale = rf.abs().max().item()
        err = (rh - rf).abs().max().item()
        assert err <= KERNEL_RTOL * scale, (name, err)
        assert not torch.equal(rh, rf), name   # the emulation is not a no-op
        bad = ih != i_f
        if bad.any():
            y, hop, ms, lo, hi, lm, Cf, Sf, Ec, Es, pairs, W = args
            cc, denom = FX.fused_correlation(
                y.double(), hop, ms, lm.double(), Cf.double(), Sf.double(),
                Ec.double(), Es.double(), pairs, W)
            col = torch.arange(cc.shape[-1])
            valid = (col >= lo[:, :, None, None]) & (col <= hi[:, :, None, None])
            best = cc.masked_fill(~valid, float("-inf")).amax(-1)
            own = cc.gather(-1, ih.long()[..., None])[..., 0]
            assert (((best - own) / denom)[bad] <= KERNEL_RTOL).all(), name


def test_reference_default_is_the_documented_rounding():
    """'default': the windows, the cross-spectra and the four tables
    rounded once to tf32, fp32 sums."""
    args = _ragged_args()
    y, hop, ms, lo, hi, lm, Cf, Sf, Ec, Es, pairs, W = args
    cc, denom = FX.fused_correlation(*args[:3], lm, Cf, Sf, Ec, Es, pairs, W,
                                     precision="default")
    # the windows as the plain version forms them
    Bg, C, T = y.shape
    w = torch.arange(W)
    start = torch.minimum(w[None, :] * hop.long(), ms.long())
    t = start[:, :, None] + torch.arange(48)
    raw = torch.gather(y[:, None].expand(Bg, W, C, T), 3,
                       t.clamp(max=T - 1)[:, :, None, :].expand(Bg, W, C, 48))
    raw = torch.where((t < T)[:, :, None, :], raw, torch.zeros(()))
    m = lm[:, None, None, :]
    raw = raw * m
    win = (raw - raw.sum(-1, keepdim=True) / lm.sum(-1)[:, None, None, None]) * m
    r = XP.tf32_round
    ReF = r(win) @ r(Cf)
    ImF = -(r(win) @ r(Sf))
    i, j = pairs[:, 0].long(), pairs[:, 1].long()
    ReCS = ReF[:, :, j] * ReF[:, :, i] + ImF[:, :, j] * ImF[:, :, i]
    ImCS = ImF[:, :, j] * ReF[:, :, i] - ReF[:, :, j] * ImF[:, :, i]
    want = r(torch.cat([ReCS, -ImCS], -1)) @ r(torch.cat([Ec, Es], 0))
    torch.testing.assert_close(cc, want, rtol=0, atol=0)


def test_reference_default_sum_order_stays_within_the_default_tolerance(stream_args):
    """Two orders of the 'default' sums (fp32 matmuls; float64, rounded to
    fp32) move rho by less than FUSED_DEFAULT_ATOL: the tf32 rounding of the
    cross-spectra shows the order of the forward sums, which the card's
    kernel takes in its own order, and the tolerance covers it."""
    orig = XP._product

    def in_f64(a, b, precision):   # both DFTs at 'default'
        return (XP.tf32_round(a).double() @ XP.tf32_round(b).double()).float()

    for name, args in _cases(stream_args):
        r0, i0 = FX.fused_xcorr_bucket_reference(*args, precision="default")
        XP._product = in_f64
        try:
            r1, i1 = FX.fused_xcorr_bucket_reference(*args, precision="default")
        finally:
            XP._product = orig
        assert (r0 - r1).abs().max().item() <= FUSED_DEFAULT_ATOL, name


@pytest.mark.parametrize("Lg", [48, 77, 600])
def test_split_tables_shapes_padding_and_reconstruction(Lg):
    """`prepare` at 'high' and 'default': the split transposed tables; at
    'highest': nothing (the fp32 tile reads the tables as they are)."""
    tab = FX.precompute_fused_tables(Lg, PAIRS, 4)
    Cf, Sf, Ec, Es = (torch.from_numpy(tab[k]) for k in ("Cf", "Sf", "Ec", "Es"))
    Kp, nlag = Ec.shape
    Lgp = -(-Lg // 32) * 32
    assert FX.prepare(Cf, Sf, Ec, Es, "highest") is None
    st = FX.prepare(Cf, Sf, Ec, Es, "high")
    dflt = FX.prepare(Cf, Sf, Ec, Es, "default")
    assert all(torch.equal(st[k], dflt[k]) for k in st)
    assert set(st) == {"fwd", "inv"}
    fwd, inv = st["fwd"], st["inv"]
    assert fwd.shape == (2, 2 * Kp, Lgp) and fwd.is_contiguous()
    assert inv.shape == (2, nlag, 2 * Kp) and inv.is_contiguous()
    assert Kp % FX.TILE == 0 and nlag % FX.TILE == 0
    assert not fwd[:, :, Lg:].any()
    for t, full in ((fwd[:, :, :Lg], torch.cat([Cf, Sf], 1).t()),
                    (inv, torch.cat([Ec, Es], 0).t())):
        assert torch.equal(t[0], XP.tf32_round(full.contiguous()))
        rec = t[0].double() + t[1].double()
        assert ((rec - full.double()).abs() <= 2.0 ** -21 * full.double().abs()).all()


@pytest.mark.parametrize("K2,nlag", [(256, 131), (200, 77), (2432, 2399)])
def test_padded_lag_table_gives_the_unpadded_result(K2, nlag):
    """The fp32 route's operand: e2 zero-padded to the 128-lag tile and the
    16-wide K chunk.  The plain version on it (cs2 padded alike) returns the
    unpadded (peak, idx): idx exact, peak within fp32 rounding."""
    rng = np.random.default_rng(K2 + nlag)
    R = 97
    cs2 = torch.from_numpy(rng.standard_normal((R, K2)).astype(np.float32))
    e2 = torch.from_numpy(rng.standard_normal((K2, nlag)).astype(np.float32))
    half = nlag // 2
    bh = rng.integers(0, half + 1, R)
    lo = torch.from_numpy((half - bh).astype(np.int32))
    hi = torch.from_numpy((half + bh).astype(np.int32))
    e2p = XP.prepare(e2, "highest")
    K2p, nlag_p = -(-K2 // 16) * 16, -(-nlag // 128) * 128
    assert e2p.shape == (K2p, nlag_p) and e2p.is_contiguous()
    assert torch.equal(e2p[:K2, :nlag], e2)
    assert not e2p[K2:].any() and not e2p[:, nlag:].any()
    cs2p = torch.nn.functional.pad(cs2, (0, K2p - K2))
    p0, i0 = XP.icorr_peak_reference(cs2, e2, lo, hi)
    p1, i1 = XP.icorr_peak_reference(cs2p, e2p, lo, hi)
    assert torch.equal(i0, i1)
    torch.testing.assert_close(p1, p0, rtol=1e-6, atol=1e-6 * p0.abs().max().item())


@pytest.mark.parametrize("precision", PRECISIONS)
def test_cpu_tensors_compute_fp32_at_every_precision(precision):
    """A CPU tensor takes the fp32 plain version whatever the precision,
    counts no launch on either route, and builds nothing."""
    args = _ragged_args()
    before = (FX.launches, FX.launches_tc)
    got = FX.fused_xcorr_bucket(*args, precision=precision)
    want = FX.fused_xcorr_bucket_reference(*args)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert (FX.launches, FX.launches_tc) == before
    assert FX._bound is None


def test_unknown_precision_raises():
    args = _ragged_args()
    for bad in ("fp16", "HIGH", None):
        with pytest.raises(ValueError, match="precision"):
            FX.fused_xcorr_bucket(*args, precision=bad)
        with pytest.raises(ValueError, match="precision"):
            FX.fused_xcorr_bucket_reference(*args, precision=bad)
        with pytest.raises(ValueError, match="precision"):
            FX.fused_correlation(*args[:3], *args[5:], precision=bad)


@pytest.fixture(scope="module")
def jax_fused_highest(small_stream):
    st = small_stream
    jp, _ = _plans(st, 4, "adaptive")
    rij = get_rij(st.latitudes, st.longitudes, st.nchans)
    return JPipe(jp, rij, xcorr_method="fused", matmul_precision="highest").run_raw(st.data)


@pytest.mark.parametrize("precision", PRECISIONS)
def test_pipeline_cpu_equals_jax_fused_highest(small_stream, jax_fused_highest, precision):
    """The port's CPU fused pipeline at every precision builds no split
    table, computes IEEE fp32 and equals the JAX fused run (interpret mode)
    at 'highest' within 1e-4 on every output."""
    st = small_stream
    _, tp = _plans(st, 4, "adaptive")
    rij = get_rij(st.latitudes, st.longitudes, st.nchans)
    pipe = TPipe(tp, rij, xcorr_method="fused", matmul_precision=precision, device="cpu")
    assert pipe._xtab and all(t["prepared"] is None for t in pipe._xtab.values())
    _close(pipe.run_raw(st.data), jax_fused_highest, OUTS)


@pytest.mark.parametrize("precision", PRECISIONS)
def test_prepare_icorr_operand_is_the_routes_table(precision):
    """`xcorr_peak.prepare`: the padded e2 for the fp32 route, the split
    transposed e2 for the tensor cores."""
    e2 = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (256, 131)).astype(np.float32))
    want = XP.pad_lag_table(e2) if precision == "highest" else XP.transpose_split_table(e2)
    assert torch.equal(XP.prepare(e2, precision), want)


# the canonical plan's largest bucket (C 8, P 28, Lg 1200, W 79) and a
# 30-element array over an hour at 20 Hz (P 435, W 1440), which the
# one-launch design took whole
CANONICAL = dict(Bg=1, C=8, T=24000, Lg=1200, W=79, Kp=1280, nlag=2432, P=28)
LARGE = dict(Bg=1, C=30, T=72000, Lg=1200, W=1440, Kp=1280, nlag=2432, P=435)


@pytest.mark.parametrize("precision", PRECISIONS)
def test_chunk_plan_takes_a_canonical_bucket_whole(precision):
    chunk, shapes = FX.plan_chunks(**CANONICAL, precision=precision)
    assert chunk == CANONICAL["Bg"] * CANONICAL["W"]
    assert max(int(np.prod(v)) for v in shapes.values()) <= FX.SCRATCH_FLOATS


@pytest.mark.parametrize("precision", PRECISIONS)
def test_chunk_plan_bounds_the_scratch_of_a_large_array(precision):
    """P * W * 2 Kp cross-spectra floats (3.2e9 at 'high') would need 64-bit
    offsets and 13 GB in one launch: the plan cuts the windows into chunks
    whose every buffer fits SCRATCH_FLOATS, and the chunks cover them."""
    chunk, shapes = FX.plan_chunks(**LARGE, precision=precision)
    n = LARGE["Bg"] * LARGE["W"]
    assert 1 <= chunk < n
    assert max(int(np.prod(v)) for v in shapes.values()) <= FX.SCRATCH_FLOATS
    planes = 2 if precision == "high" else 1
    # 'highest' keeps its cross-spectra K-major, the rows rounded up to 4
    cs = lambda n: ((2 * LARGE["Kp"], -(-n * LARGE["P"] // 4) * 4)
                    if precision == "highest" else
                    (planes, n * LARGE["P"], 2 * LARGE["Kp"]))
    assert shapes["cs"] == cs(chunk)
    assert shapes["part_val"] == (LARGE["nlag"] // FX.TILE, chunk * LARGE["P"])
    _, one = FX.plan_chunks(**LARGE, precision=precision, budget=1)
    assert one["cs"] == cs(1)


def test_chunk_plan_refuses_offsets_past_32_bits():
    with pytest.raises(ValueError, match=r"Bg\*C\*T .*\(y \(4, 30, 20000000\)"):
        FX.plan_chunks(**dict(LARGE, Bg=4, T=20_000_000), precision="high")
    with pytest.raises(ValueError, match="one window"):
        FX.plan_chunks(**dict(LARGE, P=500_000), precision="high")
