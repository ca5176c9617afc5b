"""PyTorch port: the LTS solve's final subset in one launch
(ops/kernels/lts_sweep.py::final, csrc/lts_sweep.cu::nbls_lts_final) on the
CPU.

On the CPU `final` is its plain version, `final_reference`.  It must be bit
for bit the separate passes the solve ran before it (`ops.lts._final_passes`,
still the route of rows longer than 64 equations) in the first minimum's
objective, the retained subset and the refit, and within 1e-6 (relative) in
sigma_tau and the two uncertainties, whose sums it takes as fixed trees
where the passes take ``torch.sum``: on the candidates of an exhaustive
sweep, the funnel's survivors, a chunked sweep's block minima and the
one-band programs' delay roles, at every P the sweep is tested at, with
adversarial rows (tied and infinite objectives, a NaN or infinite best fit,
tied and signed-zero residuals, a degenerate retained subset).  The kernel
runs only on the card: ``chip_smoke.py --phases lts`` holds it bit for bit
against `final_reference` there; here the warp's first-minimum merge is
emulated in numpy against ``torch.argmin``.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from narrow_band_least_squares_tpu_torch.ops import lts as TL
from narrow_band_least_squares_tpu_torch.ops.kernels import lts_sweep as LS
from narrow_band_least_squares_tpu_torch.utils.geometry import coarray

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402  (the bound's work count; imports numpy only)

# P -> elements of a co-array, or None: a random (P, 2) co-array (64 is the
# kernel's longest row, 65 and 120 go to the separate passes)
SIZES = {3: 3, 6: 4, 10: 5, 15: 6, 21: 7, 28: 8, 36: 9, 64: None, 65: None, 120: 16}
FUNNEL_K = 16
CHUNK = 40
# sigma_tau and the uncertainties: the fixed trees against torch.sum's
# order, a few float32 roundings of sums of up to 120 terms
RTOL = 1e-6
# one-band role masks (bits of LS.FINAL_ROLES) -> the delay sites they stand for
ROLE_SITES = {0b01: {"final.i", "final.j"}, 0b10: {"sigma2"}, 0b11: {"final.i", "final.j",
                                                                     "sigma2"}}


def _bits(t):
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32).numpy()


def _geometry(P, seed, windows=(2, 3), degenerate=False):
    """(tau, X, lag) at P: plane-wave delays on integer lags at fs = 10, a
    fifth of the equations hit by outliers, a row of equal delays and -0.0
    delays; ``degenerate``: X on a line (X1 = 0), so every refit is
    singular (s = 0, |s|^2 at its floor)."""
    rng = np.random.default_rng(seed)
    nch = SIZES[P]
    if nch is None:
        X = rng.standard_normal((P, 2))
    else:
        theta = np.linspace(0, 2 * np.pi, nch, endpoint=False)
        X = coarray(np.stack([np.cos(theta) * rng.uniform(0.5, 1.5, nch),
                              np.sin(theta) * rng.uniform(0.5, 1.5, nch)]))[0]
    if degenerate:
        X[:, 1] = 0.0
    tau = (X @ rng.standard_normal(windows + (2, 1)) * 0.5)[..., 0]
    tau = tau + 0.02 * rng.standard_normal(windows + (P,))
    k = max(P // 5, 1)
    tau[..., :k] += rng.standard_normal(windows + (k,))
    lag = np.round(tau * 10).astype(np.float32)
    tau = (lag * np.float32(0.1)).astype(np.float32)
    tau[0, 1], lag[0, 1] = np.float32(0.5), 5.0          # a row of equal delays
    tau[1, 0, :3], lag[1, 0, :3] = -0.0, -0.0
    return (torch.as_tensor(tau), torch.as_tensor(X, dtype=torch.float32),
            torch.as_tensor(lag))


def _candidates(tau, X, mode, seed):
    """(obj (..., K), s (..., K, 2), h) as `lts_solve` hands them to the
    final subset: the exhaustive sweep's candidates (capped at 100 above 15
    equations), the funnel's survivors or a chunked sweep's block minima."""
    P = X.shape[0]
    ci = TL.precompute_candidates(X.double().numpy(), max_candidates=100 if P > 15 else 0,
                                  seed=seed)
    cand, Ainv = torch.as_tensor(ci["cand"]).long(), torch.as_tensor(ci["Ainv"]).float()
    ok, h = torch.as_tensor(ci["ok"]), TL.lts_h(0.75, P)
    if mode == "chunked":
        blocks = [TL._best(*TL._candidate_sweep(tau, X, cand[c:c + CHUNK], Ainv[c:c + CHUNK],
                                                ok[c:c + CHUNK], h, 4))
                  for c in range(0, cand.shape[0], CHUNK)]
        return (torch.stack([b[0] for b in blocks], -1),
                torch.stack([b[1] for b in blocks], -2), h)
    obj, s = TL._candidate_sweep(tau, X, cand, Ainv, ok, h, 4,
                                 FUNNEL_K if mode == "funnel" else 0)
    return obj, s, h


def _adversarial(obj, s):
    """Rows the kernel must take as the passes do: window (0, 0) an
    all-inf row; (0, 2) its minimum tied at three candidates (the first
    wins); (1, 1) a NaN best fit, (1, 2) an infinite one."""
    obj, s = obj.clone(), s.clone()
    K = obj.shape[-1]
    obj[0, 0] = float("inf")
    lo = obj[0, 2].min()
    for k in (K - 1, K // 2, max(K - 2, 0)):
        obj[0, 2, k] = lo
    for w, bad in (((1, 1), (float("nan"), 0.3)), ((1, 2), (float("inf"), 0.0))):
        obj[w][K // 3] = -1.0                           # the strict minimum
        s[w][K // 3] = torch.tensor(bad)
    return obj, s


def _compare(got, want, rtol=RTOL):
    for k in ("objective", "s", "retained"):
        np.testing.assert_array_equal(_bits(got[k]) if k != "retained" else got[k].numpy(),
                                      _bits(want[k]) if k != "retained" else want[k].numpy(),
                                      err_msg=k)
    for k in ("sig_tau", "vel_uncert", "baz_uncert"):
        torch.testing.assert_close(got[k], want[k], rtol=rtol, atol=0, equal_nan=True, msg=k)


# (P, mode): the funnel where it runs (more than FUNNEL_K candidates)
CASES = [(P, mode) for P in SIZES
         for mode in ("exhaustive", "funnel", "chunked", "one-band", "degenerate")
         if mode != "funnel" or P * (P - 1) // 2 > FUNNEL_K]


@pytest.mark.parametrize("P,mode", CASES)
def test_final_reference_is_the_passes(P, mode):
    """`final_reference` (and `final` on CPU tensors, which launches
    nothing) against `_final_passes`: bit for bit in objective, s and
    retained, sigma_tau and the uncertainties within RTOL; on adversarial
    rows too."""
    tau, X, lag = _geometry(P, seed=P, degenerate=mode == "degenerate")
    obj, s, h = _candidates(tau, X, "exhaustive" if mode == "one-band" else
                            "exhaustive" if mode == "degenerate" else mode, seed=P)
    assert obj.shape[-1] == FUNNEL_K or mode != "funnel"
    obj, s = _adversarial(obj, s)
    dof = max(h - 2, 1)
    contract = TL.refit_contractions(P, "final")
    before = LS.launches_final
    for roles in (ROLE_SITES if mode == "one-band" else (0,)):
        delay = TL._Delay(lag, 0.1, ROLE_SITES[roles]) if roles else None
        want = TL._final_passes(tau, X, obj, s, h, dof, delay)
        got = LS.final(tau, X, obj, s, h, dof, contract, lag, 0.1, roles)
        _compare(got, want)
        _compare(LS.final_reference(tau, X, obj, s, h, dof, contract, lag, 0.1, roles), got,
                 rtol=0)
        assert (got["retained"].sum(-1) == h).all()
    assert LS.launches_final == before
    assert torch.isinf(got["objective"][0, 0])
    # the NaN and infinite best fits: every key +inf, so the first h are kept
    assert got["retained"][1, 1:, :h].all()
    if mode == "degenerate":         # every refit singular: s = 0, |s|^2 at its floor
        assert not got["s"].any() and torch.isfinite(got["vel_uncert"]).all()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_final_reference_narrow_dtype(dtype):
    """In a narrow dtype the first minimum, the retained subset and the
    refit are the passes' bit for bit; sigma_tau and the uncertainties
    within 2^-6 (relative), four roundings of bfloat16's 2^-8: every add of
    the two sum orders rounds to the dtype."""
    tau, X, _ = _geometry(28, seed=5)
    obj, s, h = _candidates(tau, X, "exhaustive", seed=5)
    tau, X, obj, s = (t.to(dtype) for t in (tau, X, obj, s))
    got = LS.final(tau, X, obj, s, h, h - 2, TL.refit_contractions(28, "final"))
    want = TL._final_passes(tau, X, obj, s, h, h - 2)
    assert all(got[k].dtype == dtype for k in got if k != "retained")
    _compare(got, want, rtol=2.0 ** -6)


def test_final_route():
    """`final_route`: the kernel (one warp a window) at P <= 64 in float32,
    bfloat16 and float16, the separate passes above and in other dtypes; on
    the card `final` holds the route its launcher reports to it."""
    for dt in (torch.float32, torch.bfloat16, torch.float16):
        for P in range(1, 1025):
            assert LS.final_route(P, dt) == ("warp" if P <= LS.WARP_P else "passes"), P
    assert LS.final_route(28, torch.float64) == "passes"
    assert LS.WARP_P == 64 and LS.ROUTES[1] == "warp"


@pytest.mark.parametrize("P", [28, 65])
def test_lts_solve_takes_the_route(monkeypatch, P):
    """`lts_solve` reaches `lts_sweep.final` at P <= 64 and `_final_passes`
    above; sent through the passes at P <= 64 it keeps objective, s and
    retained bit for bit, and sigma_tau and the uncertainties within
    RTOL."""
    tau, X, _ = _geometry(P, seed=11)
    ci = TL.precompute_candidates(X.double().numpy(), max_candidates=200)
    args = (torch.as_tensor(ci["cand"]), torch.as_tensor(ci["Ainv"]).float(),
            torch.as_tensor(ci["ok"]), TL.lts_h(0.75, P))
    calls = []
    real_final, real_passes = LS.final, TL._final_passes
    monkeypatch.setattr(LS, "final", lambda *a, **k: calls.append("warp") or real_final(*a, **k))
    monkeypatch.setattr(TL, "_final_passes",
                        lambda *a, **k: calls.append("passes") or real_passes(*a, **k))
    got = TL.lts_solve(tau, X, *args)
    assert calls == [LS.final_route(P, tau.dtype)]
    monkeypatch.setattr(LS, "final_route", lambda P, dtype: "passes")
    want = TL.lts_solve(tau, X, *args)
    _compare(got, want, rtol=RTOL)
    for k in ("vel", "baz"):
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0, equal_nan=True)


def test_final_roles():
    """The role bits of the final subset from `delay_contracted`'s sites:
    the ranks' keys ("final.i" and "final.j", together) and sigma2."""
    assert LS.FINAL_ROLES == ("final", "sigma2")
    assert TL.final_roles(frozenset()) == 0
    assert TL.final_roles({"final.i", "final.j"}) == 0b01
    assert TL.final_roles({"sigma2", "objective.i"}) == 0b10
    for P in (3, 15, 28, 36, 120):
        for schedule in ("exhaustive", "funnel", "chunk"):
            assert TL.final_roles(TL.delay_contracted(P, schedule)) == 0b11
    with pytest.raises(ValueError, match="together"):
        TL.final_roles({"final.i"})


def test_final_takes_float32_lags():
    """A delay role needs float32 lags; a role mask of 0 ignores them."""
    tau, X, lag = _geometry(15, seed=3)
    obj, s, h = _candidates(tau, X, "exhaustive", seed=3)
    with pytest.raises(TypeError, match="float32"):
        LS.final(tau, X, obj, s, h, h - 2, roles=0b01)
    with pytest.raises(TypeError, match="float32"):
        LS.final(tau, X, obj, s, h, h - 2, lag=lag.half(), roles=0b10)
    plain = LS.final(tau, X, obj, s, h, h - 2)
    _compare(LS.final(tau, X, obj, s, h, h - 2, lag=lag, inv_fs=0.1), plain, rtol=0)


def _warp_first_min(obj):
    """csrc/lts_sweep.cu::final_kernel's first minimum of rows obj (R, K),
    step by step in numpy: lane l strides over k = l, l + 32, ... keeping
    the first (value, index) of `first_min_before`'s order (NaN first, then
    the smaller value, ties by index), from (+inf, K); then
    ``__shfl_down_sync`` merges at 16, 8, 4, 2, 1 (a lane past 31 reads its
    own); lane 0's index."""
    R, K = obj.shape

    def before(va, ia, vb, ib):
        na, nb = np.isnan(va), np.isnan(vb)
        return np.where(na != nb, na, np.where(na | (va == vb), ia < ib, va < vb))

    best = np.full((R, 32), np.inf, dtype=np.float32)
    bi = np.full((R, 32), K)
    for k0 in range(0, K, 32):
        lanes = np.arange(min(32, K - k0))
        v, i = obj[:, k0 + lanes], np.broadcast_to(k0 + lanes, (R, len(lanes)))
        take = before(v, i, best[:, lanes], bi[:, lanes])
        best[:, lanes] = np.where(take, v, best[:, lanes])
        bi[:, lanes] = np.where(take, i, bi[:, lanes])
    for m in (16, 8, 4, 2, 1):
        src = np.minimum(np.arange(32) + m, 31)
        src = np.where(np.arange(32) + m < 32, src, np.arange(32))
        v, i = best[:, src], bi[:, src]
        take = before(v, i, best, bi)
        best, bi = np.where(take, v, best), np.where(take, i, bi)
    return bi[:, 0]


@pytest.mark.parametrize("K", [1, 5, 16, 31, 32, 33, 378, 1000])
def test_warp_first_minimum_is_argmin(K):
    """The kernel's first minimum (lanes striding over K, then the shuffle
    merge) is ``torch.argmin``'s index, on rows of exact ties (the first
    wins), +-0.0, all-inf rows (index 0), NaN (argmin's minimum, the first
    NaN) and -inf."""
    rng = np.random.default_rng(K)
    x = (rng.integers(0, 4, (600, K)) * 0.5).astype(np.float32)
    u = rng.random(x.shape)
    x[(x == 0) & (u < 0.5)] = -0.0
    x[u > 0.9] = np.inf
    x[:50] = np.inf                                    # all-inf rows
    x[50:100][u[50:100] < 0.05] = np.nan
    x[100:150][u[100:150] < 0.02] = -np.inf
    np.testing.assert_array_equal(_warp_first_min(x), torch.argmin(torch.as_tensor(x), -1))


@pytest.mark.parametrize("roles", [0, 0b11])
def test_lts_final_work_counts(roles):
    """`chip_smoke.lts_sweep_work("final", ...)`: bytes of obj read once,
    the first minimum's fit, tau and X (and the lags under a role), the
    outputs written once (objective, s, sig_tau and the two uncertainties,
    a byte of retained an equation); K - 1 comparisons for the minimum and
    P (P - 1) / 2 for the ranks a window; at canonical about 1.1 MB, bound
    by bytes."""
    rows, K, P = 632, 378, 28
    (flops, cmps), nbytes = chip_smoke.lts_sweep_work("final", rows, K, P, roles=roles)
    assert nbytes == (4 * (rows * K + 2 * rows + rows * P + 2 * P + 6 * rows) + rows * P
                      + (4 * rows * P if roles else 0))
    assert cmps == rows * (K - 1 + P * (P - 1) // 2) and flops > 0
    bound, by = chip_smoke.sweep_bound(rows, K, P, name="final", roles=roles)
    assert by == "bytes" and bound == pytest.approx(nbytes / chip_smoke.PEAK_HBM_BYTES * 1e3)
    if not roles:
        assert 1.0e6 < nbytes < 1.2e6
