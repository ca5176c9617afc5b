"""PyTorch port: the 'highest' (IEEE fp32) route of ``fused_xcorr_bucket``.

On the card both products run on the fp32 ring tile of
``csrc/simt_ring.cuh``: each product's K parts (``fused_xcorr.k_parts``)
are the CTAs of one thread-block cluster, each an fmaf chain from 0, added
on chip in part order.  The kernels run only on the card, where
``chip_smoke.py`` holds them against ``fused_xcorr_bucket_reference``.
Here, on the CPU:

- the K-part plan covers [0, Lgp) and [0, 2 Kp) in ascending whole chunks,
  depends on the shapes alone, and keeps the forward parts of the design
  before the clusters (so the spectra keep their bits);
- the chunk plan's scratch: one K-major spectra plane at 'highest', the
  tensor-core routes' planes unchanged;
- the parts' sum in order, emulated in float32, lies within 1e-5 of the
  plain version;
- the CPU pipeline at 'highest' equals the JAX package's fused run;
- the wrapper's pass names follow the C entry's numbering.
"""

import inspect
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from narrow_band_least_squares_tpu.models.narrowband import NarrowBandPipeline as JPipe
from narrow_band_least_squares_tpu.utils.geometry import get_rij
from narrow_band_least_squares_tpu_torch.models.narrowband import NarrowBandPipeline as TPipe
from narrow_band_least_squares_tpu_torch.ops.kernels import fused_xcorr as FX
from narrow_band_least_squares_tpu_torch.utils.device import fp32_matmul

from test_torch_fused import PAIRS, _bucket
from test_torch_pipeline import OUTS, _close, _plans

KERNEL_RTOL = 1e-5
CSRC = Path(FX.__file__).resolve().parents[2] / "csrc"
# (Lg, Kp) of the canonical plan's buckets, the 50-band plan's shortest and
# longest, the mixed-length bucket and two short ones
SHAPES = [(1200, 1280), (1100, 1152), (1020, 1024), (940, 1024), (840, 896),
          (760, 768), (680, 768), (600, 640), (2000, 2048), (400, 512),
          (300, 384), (77, 128), (20, 128)]


def _covers(parts, K, chunk):
    assert parts[0][0] == 0 and parts[-1][1] == K
    for (a, b), (c, _) in zip(parts, parts[1:]):
        assert b == c
    for a, b in parts:
        assert a < b and a % chunk == 0 and (b % chunk == 0 or b == K)


@pytest.mark.parametrize("Lg,Kp", SHAPES)
@pytest.mark.parametrize("inverse_parts", [None, 1, 2, 4])
def test_k_parts_cover_the_sums_in_ascending_whole_chunks(Lg, Kp, inverse_parts):
    plan = FX.k_parts(Lg, Kp, "highest", inverse_parts)
    Lgp = -(-Lg // 32) * 32
    _covers(plan["forward"], Lgp, FX.K_CHUNK_F32)
    _covers(plan["inverse"], 2 * Kp, FX.K_CHUNK_F32)
    want = FX.KPARTS_INV_F32 if inverse_parts is None else inverse_parts
    assert len(plan["inverse"]) == want      # 2 Kp is a multiple of 256
    assert 1 <= len(plan["forward"]) <= FX.KSPLIT_F32
    # a cluster holds the parts: at most 8 CTAs
    assert max(len(v) for v in plan.values()) <= 8


@pytest.mark.parametrize("Lg,Kp", SHAPES)
def test_forward_parts_are_the_earlier_designs(Lg, Kp):
    """The forward's parts are those the fp32 tile summed before the
    clusters (KSPLIT_F32 parts of whole 16-sample chunks, added in order by
    a separate pass): the spectra keep their bits."""
    Lgp = -(-Lg // 32) * 32
    kpart = -(-(Lgp // 16) // FX.KSPLIT_F32) * 16
    assert FX.k_parts(Lg, Kp, "highest")["forward"] == [
        (k, min(Lgp, k + kpart)) for k in range(0, Lgp, kpart)]


@pytest.mark.parametrize("Lg", [20, 77, 300, 600, 1200, 2000])
@pytest.mark.parametrize("max_lag", [None, 9])
def test_inverse_tables_are_zero_past_lg_plus_one(Lg, max_lag):
    """The card's 'highest' inverse skips the rows of Ec and Es from Lg + 1
    on (the wrapper passes min(Kp, Lg + 1)): the padding to Kp leaves them
    zero, so their terms add nothing."""
    pairs = np.array([(0, 1), (1, 2)], np.int32)
    tab = FX.precompute_fused_tables(Lg, pairs, 3, max_lag=max_lag)
    assert tab["K"] == Lg + 1 and tab["Ec"].shape[0] >= Lg + 1
    for k in ("Ec", "Es"):
        assert not tab[k][Lg + 1:].any()
        assert tab[k][Lg].any() or k == "Es"


@pytest.mark.parametrize("precision", ["high", "default"])
def test_k_parts_on_the_tensor_cores(precision):
    plan = FX.k_parts(1200, 1280, precision)
    _covers(plan["forward"], 1216, FX.K_CHUNK_TC)
    assert len(plan["forward"]) == FX.KSPLIT_TC
    assert plan["inverse"] == [(0, 2560)]


def test_k_parts_depend_on_the_shapes_alone():
    """No row count, window count or chunk enters the plan: every output is
    a fixed function of its own row, so merged arrays and chunked launches
    give each row the same bits."""
    params = list(inspect.signature(FX.k_parts).parameters)
    assert params == ["Lg", "Kp", "precision", "inverse_parts"]
    # the wrapper takes its plan from the table shapes alone
    src = inspect.getsource(FX.fused_xcorr_bucket)
    assert "k_parts(Lg, Kp, precision)" in src


@pytest.mark.parametrize("precision", ["highest", "high", "default"])
@pytest.mark.parametrize("budget", [None, 40_000_000])
def test_spec_scratch(precision, budget):
    """'highest': one K-major spectra plane (2 Kp, rows rounded up to 4) and
    K-major windows and cross-spectra; 'high' / 'default': KSPLIT_TC planes
    of row-major spectra, as before."""
    shape = dict(Bg=1, C=30, T=72000, Lg=1200, W=1440, Kp=1280, nlag=2432, P=435)
    chunk, s = FX.plan_chunks(**shape, precision=precision, budget=budget)
    r4 = lambda n: -(-n // 4) * 4
    C, P, Kp = shape["C"], shape["P"], shape["Kp"]
    if precision == "highest":
        assert s["spec"] == (2 * Kp, r4(chunk * C))
        assert s["win"] == (1216, r4(chunk * C))
        assert s["cs"] == (2 * Kp, r4(chunk * P))
    else:
        planes = 2 if precision == "high" else 1
        assert s["spec"] == (FX.KSPLIT_TC, chunk * C, 2 * Kp)
        assert s["win"] == (planes, chunk * C, 1216)
        assert s["cs"] == (planes, chunk * P, 2 * Kp)
    assert max(int(np.prod(v)) for v in s.values()) <= (budget or FX.SCRATCH_FLOATS)
    assert s["part_val"] == (2432 // FX.TILE, chunk * P)


def _random_args(seed=11):
    ins, W = _bucket(None, seed=seed)
    tab = FX.precompute_fused_tables(48, PAIRS, 4)
    args = [torch.from_numpy(ins[k]) for k in ("y", "hop", "maxstart", "lo", "hi", "len_mask")]
    args += [torch.from_numpy(tab[k]) for k in ("Cf", "Sf", "Ec", "Es")]
    return args + [torch.from_numpy(PAIRS), W]


def _parts_emulation(args, inverse_parts):
    """rho and idx with the inverse DFT summed as the card's clusters sum
    it: each K part of `k_parts` as its own float32 product, the parts then
    added in order with float32 adds."""
    y, hop, maxstart, lo, hi, lm, Cf, Sf, Ec, Es, pairs, W = args
    Kp = Ec.shape[0]
    cc_full, denom = FX.fused_correlation(*args[:3], lm, Cf, Sf, Ec, Es, pairs, W)
    # the cross-spectra as the plain version forms them
    Bg, C, T = y.shape
    Lg = lm.shape[1]
    w = torch.arange(W)
    start = torch.minimum(w[None, :] * hop.long(), maxstart.long())
    t = start[:, :, None] + torch.arange(Lg)
    raw = torch.gather(y[:, None].expand(Bg, W, C, T), 3,
                       t.clamp(max=T - 1)[:, :, None, :].expand(Bg, W, C, Lg))
    raw = torch.where((t < T)[:, :, None, :], raw, torch.zeros(()))
    raw = raw * lm[:, None, None, :]
    mean = raw.sum(-1, keepdim=True) / lm.sum(-1)[:, None, None, None]
    win = (raw - mean) * lm[:, None, None, :]
    with fp32_matmul():
        ReF, ImF = win @ Cf, -(win @ Sf)
    i, j = pairs[:, 0].long(), pairs[:, 1].long()
    ReCS = ReF[:, :, j] * ReF[:, :, i] + ImF[:, :, j] * ImF[:, :, i]
    ImCS = ImF[:, :, j] * ReF[:, :, i] - ReF[:, :, j] * ImF[:, :, i]
    A = torch.cat([ReCS, -ImCS], dim=-1)
    B = torch.cat([Ec, Es], dim=0)
    cc = None
    for k0, k1 in FX.k_parts(Lg, Kp, "highest", inverse_parts)["inverse"]:
        with fp32_matmul():
            part = A[..., k0:k1] @ B[k0:k1]
        cc = part if cc is None else cc + part
    col = torch.arange(cc.shape[-1], dtype=torch.int32)
    valid = (col >= lo[:, :, None, None]) & (col <= hi[:, :, None, None])
    ccm = torch.where(valid, cc, torch.tensor(-torch.inf))
    peak = ccm.amax(-1)
    first = torch.where(ccm == peak[..., None], col, torch.iinfo(torch.int32).max)
    idx = first.amin(-1)
    rho = torch.where(denom > 0, peak / denom, torch.zeros_like(peak))
    return rho, idx, cc_full


@pytest.mark.parametrize("inverse_parts", [1, 2, 4])
@pytest.mark.parametrize("seed", [11, 12])
def test_part_ordered_sum_is_within_1e5_of_the_plain_version(inverse_parts, seed):
    args = _random_args(seed)
    rr, ir = FX.fused_xcorr_bucket_reference(*args, precision="highest")
    rho, idx, cc = _parts_emulation(args, inverse_parts)
    err = (rho - rr).abs()
    assert bool((err <= KERNEL_RTOL * rr.abs() + KERNEL_RTOL).all()), float(err.max())
    bad = idx != ir
    if bad.any():   # near-ties only, as chip_smoke.py's check_fused holds them
        lo, hi = args[3], args[4]
        col = torch.arange(cc.shape[-1])
        valid = (col >= lo[:, :, None, None]) & (col <= hi[:, :, None, None])
        best = cc.masked_fill(~valid, float("-inf")).amax(-1)
        own = cc.gather(-1, idx.long()[..., None])[..., 0]
        _, denom = FX.fused_correlation(*args[:3], *args[5:], precision="highest")
        assert bool((((best - own) / denom)[bad] <= KERNEL_RTOL).all())


@pytest.fixture(scope="module")
def jax_fused_highest(small_stream):
    st = small_stream
    jp, _ = _plans(st, 4, "adaptive")
    rij = get_rij(st.latitudes, st.longitudes, st.nchans)
    return JPipe(jp, rij, xcorr_method="fused", matmul_precision="highest").run_raw(st.data)


def test_pipeline_cpu_at_highest_equals_jax_fused(small_stream, jax_fused_highest):
    """As tests/test_torch_fused_precision.py holds every precision: the
    port's CPU fused pipeline at 'highest' equals the JAX fused run
    (interpret mode) at 'highest' within 1e-4 on every output."""
    st = small_stream
    _, tp = _plans(st, 4, "adaptive")
    rij = get_rij(st.latitudes, st.longitudes, st.nchans)
    pipe = TPipe(tp, rij, xcorr_method="fused", matmul_precision="highest", device="cpu")
    _close(pipe.run_raw(st.data), jax_fused_highest, OUTS)


def test_pass_names_follow_the_c_entry():
    """`_PASSES` names the passes as the C entry numbers them in its error
    codes (10000 * pass + error), and every pass it launches has a name."""
    src = (CSRC / "fused_xcorr.cu").read_text()
    doc = re.search(r"pass \+ the error of the pass that failed \(pass (.*?);", src, re.S)
    items = re.sub(r"\s*//\s*", " ", doc.group(1)).split(", ")
    numbered = {int(n): name for n, name in (it.split(" ", 1) for it in items)}
    assert numbered == FX._PASSES
    failed = {int(n) for n in re.findall(r"failed\((\d), ", src)}
    assert failed == set(FX._PASSES)
