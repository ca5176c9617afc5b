"""PyTorch port: the LTS sweep's one-launch entry point
(ops/kernels/lts_sweep.py::sweep, csrc/lts_sweep.cu::nbls_lts_sweep) on the
CPU.

On the CPU `sweep` is its plain version, `sweep_reference`.  It must be bit
for bit the composition the sweep ran before it had one kernel: C-steps of
residuals, ranks of the rank keys and masked refits, then the trimmed
objective, each role's residuals from the rounded delays or the lags
(`_composition` below writes that composition out, on the port's pieces).
Through `lts_solve` it must be bit for bit the JAX package's jitted
``lts_solve`` and its one-band program.  The kernel itself runs only on the
card: ``chip_smoke.py --phases lts`` holds it bit for bit against
`sweep_reference` there; here the thread route's pairwise rank rule is
emulated in numpy against `rank_along_last`, and `sweep_route`'s table is
checked (on the card `sweep` holds the route the launcher reports to it).
"""

import itertools
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from narrow_band_least_squares_tpu.ops import lts as JL
from narrow_band_least_squares_tpu_torch.ops import lts as TL
from narrow_band_least_squares_tpu_torch.ops import solve as TS
from narrow_band_least_squares_tpu_torch.ops.kernels import lts_sweep as LS
from narrow_band_least_squares_tpu_torch.utils.geometry import coarray

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402  (the bound's work count; imports numpy only)

# P -> elements of a co-array, or None: a random (P, 2) co-array (P = 64
# and 65 are no n(n-1)/2; 64 is the warp route's longest row, 65 the block
# route's shortest); every thread-route size (3 to 9 elements) is here
SIZES = {3: 3, 6: 4, 10: 5, 15: 6, 21: 7, 28: 8, 36: 9, 64: None, 65: None, 120: 16}


def _bits(t):
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32).numpy()


def _geometry(P, seed, windows=(2, 2), Q=12):
    """(tau, X, s, lag) at P: plane-wave delays on integer lags at fs = 10,
    a fifth of the equations hit by outliers, and candidate fits with the
    hard cases: a NaN fit, an infinite one (inf and NaN residuals), a zero
    fit on a row of equal delays (every residual tied), and -0.0 delays."""
    rng = np.random.default_rng(seed)
    nch = SIZES[P]
    if nch is None:
        X = rng.standard_normal((P, 2))
    else:
        theta = np.linspace(0, 2 * np.pi, nch, endpoint=False)
        X = coarray(np.stack([np.cos(theta) * rng.uniform(0.5, 1.5, nch),
                              np.sin(theta) * rng.uniform(0.5, 1.5, nch)]))[0]
    assert X.shape[0] == P
    tau = X @ rng.standard_normal(windows + (2, 1)) * 0.5
    tau = tau[..., 0] + 0.02 * rng.standard_normal(windows + (P,))
    tau[..., :max(P // 5, 1)] += rng.standard_normal(windows + (max(P // 5, 1),))
    lag = np.round(tau * 10).astype(np.float32)
    tau = (lag * np.float32(0.1)).astype(np.float32)
    tau[0, 1] = np.float32(0.5)                    # a row of equal delays
    lag[0, 1] = 5.0
    tau[1, 0, :3] = -0.0
    lag[1, 0, :3] = -0.0
    s = (rng.standard_normal(windows + (Q, 2)) * 0.3).astype(np.float32)
    s[0, 0, 0] = np.nan
    s[0, 0, 1] = [np.inf, 0.0]
    s[0, 1, :3] = 0.0                              # ties on the equal row
    return (torch.as_tensor(tau), torch.as_tensor(X, dtype=torch.float32),
            torch.as_tensor(s), torch.as_tensor(lag))


def _composition(tau, X, s, h, n_steps, contract, objective, lag, inv_fs, roles):
    """The sweep as the port composed it before `lts_sweep.sweep`: the
    C-steps and the trimmed objective of ``ops.lts`` on `ops.lts._Delay`,
    whose sites are the role names set in ``roles``."""
    sites = {r for k, r in enumerate(LS.ROLES) if roles >> k & 1}
    delay = TL._Delay(lag, inv_fs, sites) if roles else None
    for _ in range(n_steps):
        r2i, r2j = TL._site_residuals2(tau, X, s, delay, "step", ("i", "j"))
        weight = (TL._rank_along_last(r2i, r2j) < h).to(tau.dtype)
        s = TS.masked_refit(tau[..., None, :], X, weight, contract=contract)
    if not objective:
        return s, None
    r2i, r2j, lo, hi = TL._site_residuals2(tau, X, s, delay, "objective")
    sel = (TL._rank_along_last(r2i, r2j) < h).to(tau.dtype)
    half = (1 << max(lo.shape[-1] - 1, 0).bit_length()) // 2
    v = lo if hi is lo else torch.cat([lo[..., :half], hi[..., half:]], dim=-1)
    obj = TS.tree_sum_last(sel * v)
    return s, torch.where(torch.isnan(obj), torch.full_like(obj, float("inf")), obj)


def _contracts(P):
    """Every first level contracted, each mask `UNCONTRACTED` has at P, and
    none contracted."""
    return sorted({LS.ALL_CONTRACTED, 0} | {
        TL.refit_contractions(P, site) for site in ("loop", "single", "final")})


# no role; the C-steps' keys; the objective's i (P <= 15), i lo hi (21-28),
# i j lo (36-55), i j lo hi (66-120); every role
ROLE_MASKS = (0, 0b000011, 0b000100, 0b110100, 0b011100, 0b111100, 0b111111)


@pytest.mark.parametrize("objective", [True, False], ids=["objective", "steps-only"])
@pytest.mark.parametrize("n_steps", [0, 1, 4])
@pytest.mark.parametrize("P", list(SIZES))
def test_sweep_reference_is_the_composition(P, n_steps, objective):
    """`sweep_reference` (and `sweep` on CPU tensors, which launches
    nothing) is bit for bit the pre-kernel composition, for every contract
    mask and delay role mask, on rows with NaN, +-inf, +-0 and exact
    ties."""
    tau, X, s, lag = _geometry(P, seed=P * 10 + n_steps)
    h = TL.lts_h(0.75, P)
    before = (LS.launches_sweep, LS.launches_sweep_thread)
    for contract, roles in itertools.product(_contracts(P), ROLE_MASKS):
        want = _composition(tau, X, s, h, n_steps, contract, objective, lag, 0.1, roles)
        for fn in (LS.sweep_reference, LS.sweep):
            got = fn(tau, X, s, h, n_steps, contract, objective, lag,
                     float(np.float32(0.1)), roles)
            tag = f"{fn.__name__} contract {contract:05b} roles {roles:06b}"
            np.testing.assert_array_equal(_bits(got[0]), _bits(want[0]), err_msg=tag)
            if objective:
                np.testing.assert_array_equal(_bits(got[1]), _bits(want[1]), err_msg=tag)
            else:
                assert got[1] is None and want[1] is None
    assert (LS.launches_sweep, LS.launches_sweep_thread) == before
    if n_steps == 0 and objective:    # the NaN and infinite fits: NaN -> inf
        assert torch.isinf(got[1][0, 0, :2]).all() and torch.isfinite(got[1][1]).all()


def _rank_key(x):
    """csrc/lts_sweep.cu::rank_key in numpy: float32 bits as a monotone
    int32, NaN as +inf, -0 as +0."""
    b = x.view(np.int32).copy()
    b[np.isnan(x)] = 0x7F800000
    b[b == np.iinfo(np.int32).min] = 0
    return np.where(b < 0, b ^ 0x7FFFFFFF, b).astype(np.int64)


def _thread_ranks(x, against=None):
    """The thread route's ranks of rows x (R, P) float32, step by step as
    ``sweep_thread_kernel``'s pass takes them: one key a pair (the values
    as floats, NaN as +inf; counts as float32 from rank_i = i, c = k_j <
    k_i added to rank_i and taken from rank_j for i < j) where ``against``
    is None, else every ordered pair by ``before`` (kj < ki + (j < i)) on
    the int32 keys of x (ranked) and ``against`` (counted against)."""
    P = x.shape[-1]
    if against is None:
        key = np.where(np.isnan(x), np.float32(np.inf), x)
        rank = np.tile(np.arange(P, dtype=np.float32), (x.shape[0], 1))
        for j in range(1, P):
            for i in range(j):
                c = (key[:, j] < key[:, i]).astype(np.float32)
                rank[:, i] += c
                rank[:, j] -= c
        return rank.astype(np.int64)
    ki, kj = _rank_key(x), _rank_key(against)
    rank = np.zeros(x.shape, dtype=np.int64)
    for j in range(P):
        for i in range(P):
            rank[:, i] += kj[:, j] < ki[:, i] + (j < i)
    return rank


def _hard_values(rng, shape):
    """float32 values with many exact ties, -0.0 and +0.0, +-inf, NaN and
    negatives."""
    x = (rng.integers(-3, 6, shape) * 0.25).astype(np.float32)
    u = rng.random(shape)
    x[u < 0.06] = np.nan
    x[(u >= 0.06) & (u < 0.1)] = np.inf
    x[(u >= 0.1) & (u < 0.12)] = -np.inf
    x[(x == 0) & (u < 0.5)] = -0.0
    return x


@pytest.mark.parametrize("branch", ["pairwise", "full-count"])
@pytest.mark.parametrize("P", LS.THREAD_SIZES)
def test_thread_route_rank_rule(P, branch):
    """The thread route's rank rule equals `rank_along_last` (the plain
    version's rank) exactly, at every thread-route size: one comparison a
    pair where the ranked and counted-against keys are one, every ordered
    pair, the diagonal included, where they differ (a delay role)."""
    rng = np.random.default_rng(P)
    x = _hard_values(rng, (400, P))
    if branch == "pairwise":
        got = _thread_ranks(x)
        want = LS.rank_along_last(torch.as_tensor(x))
    else:
        against = np.where(rng.random(x.shape) < 0.5, x, _hard_values(rng, x.shape))
        got = _thread_ranks(x, against)
        want = LS.rank_along_last(torch.as_tensor(x), torch.as_tensor(against))
        assert (against != x).any()
    np.testing.assert_array_equal(got, want.long().numpy())
    if branch == "pairwise":      # a permutation of 0..P-1 in every row
        np.testing.assert_array_equal(np.sort(got, -1), np.broadcast_to(np.arange(P), got.shape))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16],
                         ids=["float32", "bfloat16", "float16"])
def test_sweep_route(dtype):
    """`sweep_route` mirrors csrc/lts_sweep.cu::sweep: the thread route at
    P = 3, 6, 10, 15, 21, 28, 36 in float32, the warp route at every other
    P <= 64 (and every P <= 64 in a narrow dtype), the block route above."""
    assert LS.THREAD_SIZES == tuple(n * (n - 1) // 2 for n in range(3, 10))
    for P in range(1, LS.MAX_P + 1):
        want = ("thread" if P in LS.THREAD_SIZES and dtype == torch.float32
                else "warp" if P <= 64 else "block")
        assert LS.sweep_route(P, dtype) == want, P


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_sweep_reference_narrow_dtype(dtype):
    """In a narrow dtype every operation rounds to it (nothing contracts),
    as the pre-kernel composition did."""
    tau, X, s, _ = _geometry(28, seed=5)
    tau, X, s = (t.to(dtype) for t in (tau, X, s))
    h = TL.lts_h(0.75, 28)
    got = LS.sweep(tau, X, s, h, 4)
    want = _composition(tau, X, s, h, 4, LS.ALL_CONTRACTED, True, None, 0.0, 0)
    assert got[0].dtype == got[1].dtype == dtype
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_bits(g), _bits(w))


def test_sweep_takes_float32_lags():
    """A delay role needs float32 lags (only float32 programs contract); a
    role mask of 0 ignores them."""
    tau, X, s, lag = _geometry(6, seed=1)
    with pytest.raises(TypeError, match="float32"):
        LS.sweep(tau, X, s, 3, 1, roles=0b100)
    with pytest.raises(TypeError, match="float32"):
        LS.sweep(tau, X, s, 3, 1, lag=lag.to(torch.bfloat16), roles=0b100)
    plain = LS.sweep(tau, X, s, 3, 1)
    for got, want in zip(LS.sweep(tau, X, s, 3, 1, lag=lag, inv_fs=0.1), plain):
        assert torch.equal(got, want)


def test_sweep_roles_table():
    """The role bits of each launch of `ops.lts._candidate_sweep`: the
    exhaustive objective's, the funnel's lone step and objective, and the
    survivors' objective, from `delay_contracted`'s sites."""
    ex28, fu36 = TL.delay_contracted(28, "exhaustive"), TL.delay_contracted(36, "funnel")
    assert LS.ROLES == ("step.i", "step.j", "objective.i", "objective.j",
                        "objective.lo", "objective.hi")
    assert TL.sweep_roles(ex28) == 0b110100                      # i lo hi
    assert TL.sweep_roles(ex28, "single") == 0b110100            # no single.* site
    assert TL.sweep_roles(TL.delay_contracted(15, "exhaustive")) == 0b000100
    assert TL.sweep_roles(fu36, "single") == 0b011111            # i j lo, single i j
    assert TL.sweep_roles(fu36, None, "survivors") == 0b011100
    assert TL.sweep_roles(TL.delay_contracted(120, "chunk")) == 0
    assert TL.sweep_roles(frozenset()) == 0


def _jax_args(X, ci):
    return (X.astype(np.float32), ci["cand"], ci["Ainv"].astype(np.float32), ci["ok"])


# (id, elements, lts_solve options): P = 3, 6, 10, 28 exhaustive and funnel
SOLVES = [("P3", 3, {}), ("P6", 4, {}), ("P10-funnel8", 5, {"funnel_k": 8}),
          ("P28-funnel16", 8, {"funnel_k": 16}), ("P28-chunk64", 8, {"candidate_chunk": 64})]


@pytest.mark.parametrize("nchans,kw", [c[1:] for c in SOLVES], ids=[c[0] for c in SOLVES])
def test_lts_solve_through_sweep_bitwise_jitted_jax(monkeypatch, nchans, kw):
    """`lts_solve`, whose candidate sweep is `lts_sweep.sweep` (one call a
    block, two with the funnel), computes the JAX package's jitted
    ``lts_solve`` bit for bit: objective, s and retained sets."""
    rng = np.random.default_rng(nchans)
    theta = np.linspace(0, 2 * np.pi, nchans, endpoint=False)
    X = coarray(np.stack([np.cos(theta) * rng.uniform(0.5, 1.5, nchans),
                          np.sin(theta) * rng.uniform(0.5, 1.5, nchans)]))[0]
    P = X.shape[0]
    ci = TL.precompute_candidates(X)
    tau = (X @ rng.standard_normal((3, 4, 2, 1)))[..., 0] + 0.05 * rng.standard_normal(
        (3, 4, P))
    tau[..., :max(P // 5, 1)] += rng.standard_normal((3, 4, max(P // 5, 1)))
    tau = tau.astype(np.float32)
    h = TL.lts_h(0.75, P)
    args = _jax_args(X, ci)
    calls, real = [], LS.sweep

    def spy(*a, **k):
        calls.append(a[4])                         # n_steps of each launch
        return real(*a, **k)

    monkeypatch.setattr(LS, "sweep", spy)
    got = TL.lts_solve(torch.as_tensor(tau), *(torch.as_tensor(a) for a in args), h, 4, **kw)
    Q, chunk = len(ci["cand"]), kw.get("candidate_chunk", 0)
    blocks = -(-Q // chunk) if chunk and chunk < Q else 1
    assert calls == ([1, 3] if "funnel_k" in kw else [4]) * blocks
    want = jax.jit(lambda t, *a: JL.lts_solve(t, *a, h, 4, **kw))(tau, *args)
    np.testing.assert_array_equal(got["retained"].numpy(), np.asarray(want["retained"]))
    for k in ("objective", "s"):
        np.testing.assert_array_equal(got[k].numpy().view(np.int32),
                                      np.asarray(want[k]).view(np.int32), err_msg=k)


def test_one_band_solve_through_sweep_bitwise_jax_program(monkeypatch):
    """At one band the sweep's objective takes the lags' roles: the port's
    `lts_solve` on the delays of the JAX package's one-band program (7
    elements, P = 21, the outlier stream's setup; its solve recorded inside
    the compiled program) is that program's objective, s and retained sets
    bit for bit on every valid window, its one sweep launch with the roles
    ``objective.i``, ``.lo`` and ``.hi``."""
    from narrow_band_least_squares_tpu.io.synthetic import synthetic_plane_wave
    from narrow_band_least_squares_tpu.models.narrowband import (
        NarrowBandPipeline as JPipe,
    )
    from narrow_band_least_squares_tpu.utils.geometry import get_rij
    from narrow_band_least_squares_tpu.utils.plan import make_plan
    from narrow_band_least_squares_tpu_torch.models import NarrowBandPipeline
    from narrow_band_least_squares_tpu_torch.utils import plan as tplan

    st = synthetic_plane_wave(
        nchans=7, duration_s=240.0, fs=10.0, baz_deg=120.0, trace_vel_kms=0.30, f0=0.6,
        bandwidth=0.8, snr=15.0, aperture_km=2.5, seed=11, outlier_channels=(2,))
    rij = get_rij(st.latitudes, st.longitudes, st.nchans)
    args = ([0.3, 1.2], "linear", [30.0], 0.5, st.npts, st.fs)
    rec, real_jax = [], JL.lts_solve

    def jspy(tau, X, *a, **k):
        out = real_jax(tau, X, *a, **k)
        jax.debug.callback(lambda *v: rec.append([np.asarray(x) for x in v]),
                           tau, out["objective"], out["s"], out["retained"])
        return out

    monkeypatch.setattr(JL, "lts_solve", jspy)
    JPipe(make_plan(*args), rij, alpha=0.75).run_raw(st.data)
    jax.effects_barrier()
    tau, obj, s, ret = rec[-1]
    pipe = NarrowBandPipeline(tplan.make_plan(*args), rij, alpha=0.75, device="cpu")
    g, wm = pipe._geometry, pipe.state_dict()["win_mask"].numpy()
    assert tau.shape[-1] == 21 and pipe._delay_sites == TL.delay_contracted(21, "exhaustive")
    lag = torch.as_tensor(np.rint(tau.astype(np.float64) * st.fs).astype(np.float32))
    roles, real = [], LS.sweep

    def spy(*a, **k):
        roles.append(k.get("roles", 0))
        return real(*a, **k)

    monkeypatch.setattr(LS, "sweep", spy)
    out = TL.lts_solve(torch.as_tensor(tau.copy()), g["X"], g["cand"], g["Ainv"],
                       g["cand_ok"], pipe.h, pipe.c_steps, lag=lag, inv_fs=1.0 / st.fs,
                       delay_sites=pipe._delay_sites)
    assert roles == [TL.sweep_roles(pipe._delay_sites)] == [0b110100]
    for k, w in (("objective", obj), ("s", s)):
        np.testing.assert_array_equal(out[k].numpy().view(np.int32)[wm],
                                      w.view(np.int32)[wm], err_msg=k)
    np.testing.assert_array_equal(out["retained"].numpy()[wm], ret[wm])


@pytest.mark.parametrize("P,n_steps,objective", [(28, 4, True), (28, 1, False), (15, 3, True),
                                                 (120, 4, True), (1, 2, True)])
def test_lts_sweep_work_counts(P, n_steps, objective):
    """`chip_smoke.lts_sweep_work("sweep", ...)`: per row, each C-step's
    residuals (5 float operations an equation: a multiply, a fused
    multiply-add as two, a subtract and the square), five refit trees and
    the 2x2 solve (12), the objective's residuals, sel * r2 and its tree's
    adds; P (P - 1) / 2 comparisons a rank pass (each unordered pair once);
    bytes of tau, X, s in and out and the objective."""
    rows, Q = 3, 7
    (flops, cmps), nbytes = chip_smoke.lts_sweep_work("sweep", rows, Q, P, n_steps=n_steps,
                                                      objective=objective)
    p2 = 1 << max(P - 1, 0).bit_length()
    half = p2 // 2
    # a tree: P leaf products, P - half products past half, half fused
    # multiply-adds (two each), half - 1 adds
    tree = P + (P - half) + 2 * half + (half - 1)
    per_row = n_steps * (5 * P + 5 * tree + 12) + (
        (5 * P + P + (p2 - 1 if P > 1 else 0)) if objective else 0)
    assert flops == rows * Q * per_row
    assert cmps == rows * Q * (n_steps + objective) * (P * (P - 1) // 2)
    assert nbytes == 4 * (rows * P + 2 * P + 4 * rows * Q + (rows * Q if objective else 0))
    if (P, n_steps, objective) == (28, 4, True):
        # the canonical row: 2,547 float operations and 1,890 comparisons
        assert (flops / (rows * Q), cmps / (rows * Q)) == (2547, 1890)
        bound, by = chip_smoke.sweep_bound(632, 378, 28)
        assert by == "operations" and bound == pytest.approx(
            632 * 378 * 1890 / chip_smoke.PEAK_COMPARES * 1e3)


@pytest.mark.parametrize("P", LS.THREAD_SIZES)
def test_sweep_cells(P):
    """`chip_smoke.sweep_cells`: the sweep launches of an LTS solve at P
    equations, the exhaustive sweep of every candidate pair and, where
    'auto' funnels (`lts_schedule`), one C-step on them, then the rest on
    the k survivors; a capped sweep of 5 where there are more."""
    Q = P * (P - 1) // 2
    cells = {c: (q, n) for c, q, n in chip_smoke.sweep_cells(P)}
    assert cells["exhaustive"] == (Q, 4)
    k = max(16, -(-Q // 24))
    funnel = TL.lts_schedule(Q, 0, k, 4) == "funnel"
    assert ("funnel first" in cells) == ("funnel survivors" in cells) == funnel
    if funnel:
        assert cells["funnel first"] == (Q, 1) and cells["funnel survivors"] == (k, 3)
    assert cells.get("capped") == ((5, 4) if Q > 5 else None)
