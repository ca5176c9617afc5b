"""PyTorch port: the matmul-precision contract of the lag search.

On the card ``matmul_precision`` picks the route of ``icorr_peak``:
'highest' is IEEE fp32 on the CUDA cores, 'high' 3xTF32 and 'default'
1xTF32 on the tensor cores.  The tensor-core kernel runs only on the card,
where ``chip_smoke.py`` holds it against ``icorr_peak_reference(...,
precision=)``, which emulates the tf32 split bit for bit.  Here, on the
CPU:

- the tf32 rounding helper equals a numpy emulation of ``cvt.rna.tf32.f32``
  (round to nearest, ties away from zero), including signed zeros,
  subnormals, ties, overflow and ±inf;
- ``hi + lo`` reconstructs x within 2^-21 relative;
- the emulated 'high' product is within 1e-5 of fp32, with ``idx`` equal
  except at near-ties (the kernel check of ``chip_smoke.py``);
- on a CPU tensor every precision computes IEEE fp32, as the JAX package
  does on the CPU, so the port still equals JAX there at every precision;
- the transposed, split ``e2`` table recombines to ``stack_inverse_table``;
- an unknown precision raises.
"""

import numpy as np
import pytest
import torch

from narrow_band_least_squares_tpu.models.narrowband import NarrowBandPipeline as JPipe
from narrow_band_least_squares_tpu.ops.kernels.xcorr_peak import icorr_peak as jax_icorr_peak
from narrow_band_least_squares_tpu.utils.geometry import get_rij
from narrow_band_least_squares_tpu.utils.plan import (
    get_freqlist, get_winlenlist, make_plan,
)
from narrow_band_least_squares_tpu_torch.models.narrowband import NarrowBandPipeline as TPipe
from narrow_band_least_squares_tpu_torch.ops import xcorr as TXC
from narrow_band_least_squares_tpu_torch.ops.kernels import xcorr_peak as XP
from narrow_band_least_squares_tpu_torch.utils import plan as tplan

KERNEL_RTOL = 1e-5
OUTS = ("vel", "baz", "mdccm", "sig_tau", "vel_uncert", "baz_uncert")


def rna_tf32_numpy(x: np.ndarray) -> np.ndarray:
    """cvt.rna.tf32.f32 in float64 arithmetic: keep 11 significant bits
    (10 stored), round half away from zero; the tf32 grid below 2^-126 is
    2^-136 (fp32's subnormal step with 13 bits dropped); past the largest
    tf32 value the result is inf."""
    x = np.asarray(x, np.float32)
    ax = np.abs(x.astype(np.float64))
    out = ax.copy()
    fin = np.isfinite(ax) & (ax > 0)
    _, e = np.frexp(ax[fin])                  # ax = f * 2^e, f in [0.5, 1)
    ulp = np.ldexp(1.0, np.maximum(e - 11, -136))
    q = np.floor(ax[fin] / ulp + 0.5) * ulp
    q[q >= 2.0 ** 128] = np.inf
    out[fin] = q
    return np.copysign(out, x.astype(np.float64)).astype(np.float32)


def _bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


def _special_values():
    tiny = np.float32(np.finfo(np.float32).tiny)           # 2^-126
    sub = np.float32(2.0 ** -149)
    vals = [0.0, -0.0, np.inf, -np.inf, sub, -sub, tiny, -tiny,
            np.float32(np.finfo(np.float32).max), -np.float32(np.finfo(np.float32).max),
            1.0, -1.0, 3.0e38, 1e-40, -1e-40, 5.877e-39, 123.456, -0.1]
    # exact ties: the dropped 13 bits are 0x1000 (half a tf32 step)
    tie_bits = np.array([0x3F801000, 0xBF801000, 0x3F803000, 0x00001000,
                         0x80003000, 0x7F7FF000, 0x00FFF000], np.uint32)
    return np.concatenate([np.array(vals, np.float32), tie_bits.view(np.float32)])


def test_tf32_round_matches_cvt_rna():
    rng = np.random.default_rng(0)
    x = np.concatenate([
        _special_values(),
        (rng.standard_normal(4000) * 10.0 ** rng.uniform(-30, 30, 4000)).astype(np.float32),
        rng.integers(0, 2**32, 4000, dtype=np.uint64).astype(np.uint32).view(np.float32),
        (rng.uniform(-1, 1, 500) * 2.0 ** -126).astype(np.float32),   # subnormals
    ])
    x = x[~np.isnan(x)]
    got = XP.tf32_round(torch.from_numpy(x)).numpy()
    want = rna_tf32_numpy(x)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    assert (_bits(got) & 0x1FFF == 0).all()
    # the sign of zero and of inf survives; the largest float overflows
    assert np.signbit(got[1]) and not np.signbit(got[0])
    assert np.isposinf(got[2]) and np.isneginf(got[3])
    assert np.isposinf(got[8]) and np.isneginf(got[9])


def test_tf32_round_passes_nan():
    x = torch.tensor([float("nan"), -float("nan")])
    assert torch.isnan(XP.tf32_round(x)).all()


@pytest.mark.parametrize("scale", [1e-30, 1.0, 1e30])
def test_split_reconstructs_within_2_pow_minus_21(scale):
    rng = np.random.default_rng(int(np.log10(scale)) + 40)
    x = (rng.standard_normal(20000) * scale).astype(np.float32)
    hi, lo = XP.tf32_split(torch.from_numpy(x))
    for part in (hi, lo):
        assert (_bits(part.numpy()) & 0x1FFF == 0).all()
    rec = hi.double() + lo.double()
    rel = ((rec - torch.from_numpy(x).double()).abs() / np.abs(x)).max().item()
    assert rel <= 2.0 ** -21, rel


def _case(R, K2, nlag, seed):
    rng = np.random.default_rng(seed)
    cs2 = rng.standard_normal((R, K2)).astype(np.float32)
    e2 = rng.standard_normal((K2, nlag)).astype(np.float32)
    half = nlag // 2
    bh = rng.integers(0, half + 1, R)
    return (torch.from_numpy(cs2), torch.from_numpy(e2),
            torch.from_numpy((half - bh).astype(np.int32)),
            torch.from_numpy((half + bh).astype(np.int32)))


@pytest.mark.parametrize("R,K2,nlag", [(77, 256, 131), (300, 128, 259), (64, 384, 300)])
def test_reference_high_is_fp32_within_1e5(R, K2, nlag):
    """'high' (emulated 3xTF32) against fp32: peaks within KERNEL_RTOL of
    the largest; idx equal except at near-ties, where the float64 sum of
    the split products at the 'high' idx lies within KERNEL_RTOL * scale of
    the fp32 peak (the rule ``chip_smoke.py`` holds the card to)."""
    cs2, e2, lo, hi = _case(R, K2, nlag, R + K2)
    ph, ih = XP.icorr_peak_reference(cs2, e2, lo, hi, precision="high")
    pf, i_f = XP.icorr_peak_reference(cs2, e2, lo, hi, precision="highest")
    scale = pf.abs().max().item()
    np.testing.assert_allclose(ph.numpy(), pf.numpy(), rtol=KERNEL_RTOL,
                               atol=KERNEL_RTOL * scale)
    bad = (ih != i_f).nonzero().flatten()
    if bad.numel():
        (ah, al), (bh, bl) = XP.tf32_split(cs2[bad]), XP.tf32_split(e2[:, ih[bad].long()].T)
        own = ((ah.double() * bh.double()) + al.double() * bh.double()
               + ah.double() * bl.double()).sum(-1)
        assert ((own - pf[bad].double()).abs() <= KERNEL_RTOL * scale).all()


def test_reference_split_products_are_the_emulation():
    """'default' is rna(a) @ rna(b); 'high' adds the two cross terms, and
    both differ from fp32 (the emulation is not a no-op)."""
    cs2, e2, lo, hi = _case(40, 128, 97, 5)
    full = (torch.zeros(40, dtype=torch.int32), torch.full((40,), 96, dtype=torch.int32))
    (ah, al), (bh, bl) = XP.tf32_split(cs2), XP.tf32_split(e2)
    cc = {p: XP._product(cs2, e2, p) for p in XP.PRECISIONS}
    assert torch.equal(cc["default"], ah @ bh)
    assert torch.equal(cc["high"], (al @ bh + ah @ bl) + ah @ bh)
    assert not torch.equal(cc["default"], cc["highest"])
    assert not torch.equal(cc["high"], cc["highest"])
    err = {p: (cc[p] - cc["highest"]).abs().max().item() for p in ("high", "default")}
    assert err["high"] < err["default"] / 100
    pk, _ = XP.icorr_peak_reference(cs2, e2, *full, precision="default")
    assert torch.equal(pk, cc["default"].amax(1))


def _jax_icorr(cs2, e2, lo, hi, precision):
    import jax
    import jax.numpy as jnp

    prec = {"highest": jax.lax.Precision.HIGHEST, "high": jax.lax.Precision.HIGH,
            "default": jax.lax.Precision.DEFAULT}[precision]
    peak, idx = jax_icorr_peak(
        jnp.asarray(cs2.numpy()), jnp.asarray(e2.numpy()),
        jnp.asarray(lo.numpy()[:, None]), jnp.asarray(hi.numpy()[:, None]),
        e2.shape[1], interpret=True, precision=prec,
    )
    return np.asarray(peak), np.asarray(idx)


@pytest.mark.parametrize("precision", ["highest", "high", "default"])
def test_cpu_tensor_ignores_precision_and_equals_jax(precision):
    """A CPU tensor computes IEEE fp32 at every precision, bit for bit the
    'highest' result, launches nothing, and equals the JAX kernel run on
    the CPU at the same precision (where XLA ignores the hint)."""
    cs2, e2, lo, hi = _case(150, 256, 201, 11)
    before = (XP.launches, XP.launches_tc)
    p, i = XP.icorr_peak(cs2, e2, lo, hi, precision=precision)
    p0, i0 = XP.icorr_peak(cs2, e2, lo, hi)
    assert torch.equal(p, p0) and torch.equal(i, i0)
    assert (XP.launches, XP.launches_tc) == before
    assert XP._bound_tc is None
    pj, ij = _jax_icorr(cs2, e2, lo, hi, precision)
    np.testing.assert_array_equal(i.numpy(), ij)
    np.testing.assert_allclose(p.numpy(), pj, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("K2,nlag", [(256, 131), (2432, 2399), (200, 77)])
def test_transpose_split_table_recombines_to_e2(K2, nlag):
    """(2, nlag_p, K2_p): hi = rna(e2ᵀ) exactly, hi + lo = e2ᵀ within 2^-21
    relative, zero padding to the 128-lag tile and the 32-wide K block."""
    Lmax = (nlag + 1) // 2
    tab = TXC.precompute_dft_tables(Lmax, max_lag=min(Lmax - 1, nlag // 2))
    e2 = torch.from_numpy(TXC.stack_inverse_table(tab["Ec"], tab["Es"]))
    if K2 != e2.shape[0]:   # a ragged operand, as a direct caller may pass
        e2 = torch.from_numpy(np.random.default_rng(K2).standard_normal(
            (K2, nlag)).astype(np.float32))
    K2, nlag = e2.shape
    t = XP.transpose_split_table(e2)
    nlag_p, K2_p = -(-nlag // 128) * 128, -(-K2 // 32) * 32
    assert t.shape == (2, nlag_p, K2_p) and t.is_contiguous()
    assert torch.equal(t[0, :nlag, :K2], XP.tf32_round(e2.t().contiguous()))
    rec = (t[0].double() + t[1].double())[:nlag, :K2].T
    err = (rec - e2.double()).abs()
    assert (err <= 2.0 ** -21 * e2.double().abs()).all()
    assert not t[:, nlag:].any() and not t[:, :, K2:].any()


def test_unknown_precision_raises(small_stream):
    cs2, e2, lo, hi = _case(8, 128, 9, 1)
    for bad in ("fp16", "HIGH", None):
        with pytest.raises(ValueError, match="precision"):
            XP.icorr_peak(cs2, e2, lo, hi, precision=bad)
        with pytest.raises(ValueError, match="precision"):
            XP.icorr_peak_reference(cs2, e2, lo, hi, precision=bad)
    st = small_stream
    p = tplan.make_plan([0.3, 1.2], "linear", [30], 0.5, st.npts, st.fs)
    with pytest.raises(ValueError, match="precision"):
        TPipe(p, get_rij(st.latitudes, st.longitudes, st.nchans),
              matmul_precision="bf16", device="cpu")


@pytest.mark.parametrize("method", ["mxu", "pallas"])
def test_pipeline_cpu_same_at_every_precision_and_equals_jax(small_stream, method):
    """The port's CPU pipeline gives identical outputs at 'high' (the
    default) and 'highest', builds no split table, and equals JAX
    ``run_raw`` at its default 'high' within 1e-4."""
    st = small_stream
    fl, nb, _ = get_freqlist(0.3, 1.5, "log", 4)
    wl = get_winlenlist("adaptive", nb, 0, 40, 20)
    jp = make_plan(fl, "log", wl, 0.5, st.npts, st.fs)
    tp = tplan.make_plan(fl, "log", wl, 0.5, st.npts, st.fs)
    rij = get_rij(st.latitudes, st.longitudes, st.nchans)
    want = JPipe(jp, rij, xcorr_method=method).run_raw(st.data)
    runs = {}
    for prec in ("high", "highest"):
        pipe = TPipe(tp, rij, xcorr_method=method, matmul_precision=prec, device="cpu")
        assert pipe._xtab and all(t["prepared"] is None for t in pipe._xtab.values())
        runs[prec] = pipe.run_raw(st.data)
    for k in OUTS:
        a, b = runs["high"][k], runs["highest"][k]
        assert torch.equal(torch.nan_to_num(a), torch.nan_to_num(b)), k
        np.testing.assert_allclose(a.numpy(), np.asarray(want[k]), rtol=1e-4,
                                   atol=1e-4, err_msg=k)
